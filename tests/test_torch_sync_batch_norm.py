"""BatchNorm over every rank's batch: the port against the JAX package.

At size 1, in one process:

- ``synced_matmul_bn_stats`` against the JAX ``matmul_bn_stats`` in
  interpret mode: values and gradients through a BatchNorm-shaped loss,
  with ``tests/test_conv_bn_kernel.py``'s tolerances for its sharded
  kernel (``test_sharded_kernel_matches_single_device``);
- ``FusedConv1x1BN(sync=True)`` against the JAX ``FusedConv1x1BN``, and
  bit for bit against ``sync=False``; the ResNet's ``sync_bn=True`` bit for
  bit against ``sync_bn=False`` (no allreduce at size 1);
- ``hvd.SyncBatchNorm`` against the JAX bridge's ``SyncBatchNorm`` and
  ``torch.nn.BatchNorm2d``;
- ``make_overlapped_train_step``'s refusal of a synced model at size > 1.

Across processes, one module-scoped np=2 job through the port's launcher
on the CPU (gloo), 60 s at most, each rank on its half of one seeded
batch, held against the JAX package on a ``MeshSpec(data=2)`` CPU mesh
(``tests/conftest.py`` gives 8 CPU devices):

- each rank's rows of ``y``, ``s1``, ``s2``, its rows of ``dx`` and its
  ``dw`` from ``synced_matmul_bn_stats`` against
  ``sharded_matmul_bn_stats`` (the ranks' ``dw`` sum to the JAX one);
- ``ResNet(stage_sizes=[1], num_filters=8, fp32, fuse_conv1x1_bn=True,
  sync_bn=True)`` on 8 images of 32x32 (4 per rank), the JAX model's
  weights carried by ``from_flax``, one SGD step through
  ``DistributedOptimizer`` against one ``make_sharded_train_step`` step
  with ``fused_bn_mesh`` (``test_conv_bn_kernel.py``'s
  ``test_fused_resnet_trains_on_sharded_mesh`` configuration): the loss,
  the updated parameters and ``batch_stats`` within ``TOL``; the same
  job with ``sync_bn=False`` (the control) must miss them; a second step
  in which rank 1 sends no serialized request (each layer's allreduces
  named after it hit the response cache);
- ``hvd.SyncBatchNorm`` against ``nn.BatchNorm2d`` over the concatenated
  batch: outputs, ``dx``, the summed weight and bias gradients and the
  running statistics; a local ``nn.BatchNorm2d`` (the control) misses.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.kernels import FusedConv1x1BN as JaxFusedConv1x1BN
from horovod_tpu.kernels import matmul_bn_stats as jax_matmul_bn_stats
from horovod_tpu.kernels import sharded_matmul_bn_stats
from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu.models.training import (
    TrainState,
    create_train_state,
    make_sharded_train_step,
)
from horovod_tpu.parallel import MeshSpec, build_mesh, shard_batch
from horovod_tpu_torch.convert import from_flax
from horovod_tpu_torch.kernels import FusedConv1x1BN, synced_matmul_bn_stats
from horovod_tpu_torch.models import resnet

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
# fp32 on both sides; the two sum the same terms in different orders.
TOL = dict(rtol=1e-4, atol=1e-5)
# test_conv_bn_kernel.py::test_sharded_kernel_matches_single_device.
Y_TOL = dict(rtol=1e-5, atol=1e-4)
S1_TOL = dict(rtol=1e-5, atol=1e-3)
S2_TOL = dict(rtol=1e-5, atol=1e-2)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
LR = 0.1


def _bn_loss(y, s1, s2, count, rsqrt, total):
    mean = s1 / count
    var = s2 / count - mean * mean
    return total((y - mean) * rsqrt(var + 1e-5))


def _kernel_inputs(ranks: int = 2):
    rng = np.random.RandomState(5)
    x = rng.randn(16 * ranks, 32).astype(np.float32)   # 16 rows per rank
    w = rng.randn(32, 24).astype(np.float32)
    return x, w


# ---------------------------------------------------------------------------
# size 1, in process
# ---------------------------------------------------------------------------

def test_synced_stats_at_size_one_equal_the_jax_kernel():
    x, w = _kernel_inputs()
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    yj, s1j, s2j = jax_matmul_bn_stats(xj, wj, 128, 128, 128, True)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y, s1, s2, count = synced_matmul_bn_stats(xt, wt)
    assert float(count) == x.shape[0] and not count.requires_grad
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), **Y_TOL)
    np.testing.assert_allclose(s1.detach().numpy(), np.asarray(s1j),
                               **S1_TOL)
    np.testing.assert_allclose(s2.detach().numpy(), np.asarray(s2j),
                               **S2_TOL)

    def loss_jax(xj, wj):
        yj, s1j, s2j = jax_matmul_bn_stats(xj, wj, 128, 128, 128, True)
        return _bn_loss(yj, s1j, s2j, yj.shape[0], jax.lax.rsqrt, jnp.sum)

    gx, gw = jax.grad(loss_jax, argnums=(0, 1))(xj, wj)
    _bn_loss(y, s1, s2, count, torch.rsqrt, torch.sum).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **GRAD_TOL)


def _fused_params(rng):
    return ({"kernel": (rng.randn(16, 24) * 0.2).astype(np.float32),
             "scale": (1.0 + 0.1 * rng.randn(24)).astype(np.float32),
             "bias": (0.1 * rng.randn(24)).astype(np.float32)},
            {"mean": (0.1 * rng.randn(24)).astype(np.float32),
             "var": (1.0 + 0.1 * rng.rand(24)).astype(np.float32)})


@pytest.mark.parametrize("strides", [1, 2])
def test_fused_sync_module_at_size_one_equals_flax_and_unsynced(strides):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    params, stats = _fused_params(rng)
    jmod = JaxFusedConv1x1BN(features=24, strides=(strides, strides),
                             dtype=jnp.float32)
    out_j, mut = jmod.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params),
         "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)},
        jnp.asarray(x), mutable=["batch_stats"])
    outs, grads = [], []
    for sync in (True, False):
        tmod = FusedConv1x1BN(16, 24, strides=strides, dtype=torch.float32,
                              sync=sync)
        tmod.load_state_dict(from_flax(params, stats))
        xt = torch.from_numpy(x).requires_grad_()
        out = tmod.train()(xt)
        (out * out).sum().backward()
        outs.append(out.detach())
        grads.append((xt.grad, tmod.kernel.grad, tmod.mean, tmod.var))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                                   rtol=1e-5, atol=1e-5)
        for key in ("mean", "var"):
            np.testing.assert_allclose(getattr(tmod, key).numpy(),
                                       np.asarray(mut["batch_stats"][key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_sync_bn_resnet_at_size_one_is_the_unsynced_one_bit_for_bit():
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    results = []
    for sync in (True, False):
        model = resnet.ResNet(
            stage_sizes=[1], block_cls=resnet.BottleneckBlock,
            num_classes=10, num_filters=8, dtype=torch.float32,
            fuse_conv1x1_bn=True, sync_bn=sync,
            generator=torch.Generator().manual_seed(1))
        model(x).square().sum().backward()
        results.append([p.grad for p in model.parameters()]
                       + list(model.buffers()))
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_sync_bn_names_each_layer_after_its_path():
    model = resnet.ResNet50(num_classes=10, fuse_conv1x1_bn=True,
                            sync_bn=True)
    names = {name: m.sync_name for name, m in model.named_modules()
             if getattr(m, "sync_name", None) is not None}
    # ResNet-50: the stem, 16 3x3 BatchNorms and 36 fused 1x1 layers.
    assert len(names) == 53
    assert sum(isinstance(m, FusedConv1x1BN) for m in model.modules()) == 36
    assert all(v == f"sync_bn.{k}" for k, v in names.items())
    unsynced = resnet.ResNet50(num_classes=10, fuse_conv1x1_bn=True)
    assert set(unsynced.state_dict()) == set(model.state_dict())


def test_from_flax_carries_the_jax_weights_into_the_synced_model():
    params, stats = _jax_init()
    model = resnet.ResNet(stage_sizes=[1], block_cls=resnet.BottleneckBlock,
                          num_classes=10, num_filters=8, dtype=torch.float32,
                          fuse_conv1x1_bn=True, sync_bn=True)
    state = from_flax(params, stats)
    model.load_state_dict(state)        # strict: the same names, no more
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key


@pytest.fixture
def jax_bridge():
    import horovod_tpu.frameworks.torch as ht

    ht.init()
    yield
    ht.shutdown()


@pytest.mark.parametrize("affine", [True, False])
def test_sync_batch_norm_at_size_one_equals_the_bridge_and_torch(
        jax_bridge, affine):
    from horovod_tpu.frameworks.torch.sync_batch_norm import \
        SyncBatchNorm as BridgeSyncBatchNorm

    rng = np.random.RandomState(7)
    x = rng.randn(6, 4, 5, 3).astype(np.float32)
    g = rng.randn(6, 4, 5, 3).astype(np.float32)
    mods = [hvd.SyncBatchNorm(4, momentum=0.3, affine=affine),
            BridgeSyncBatchNorm(4, momentum=0.3, affine=affine),
            torch.nn.BatchNorm2d(4, momentum=0.3, affine=affine)]
    results = []
    for mod in mods:
        if affine:
            with torch.no_grad():
                mod.weight.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
                mod.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        xt = torch.from_numpy(x).requires_grad_()
        out = mod.train()(xt)
        (out * torch.from_numpy(g)).sum().backward()
        res = [out.detach(), xt.grad, mod.running_mean.clone(),
               mod.running_var.clone()]
        if affine:
            res += [mod.weight.grad, mod.bias.grad]
        results.append(res)
        with torch.no_grad():
            results[-1].append(mod.eval()(torch.from_numpy(x)))
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_the_graph_step_refuses_a_synced_model_at_size_two():
    from horovod_tpu_torch.common.topology import ProcessTopology
    from horovod_tpu_torch.core.state import global_state

    hvd.init(device="cpu")
    state = global_state()
    topo = state.topo
    try:
        model = resnet.ResNet(stage_sizes=[1],
                              block_cls=resnet.BottleneckBlock,
                              num_classes=10, num_filters=8,
                              dtype=torch.float32, fuse_conv1x1_bn=True,
                              sync_bn=True)
        step = hvd.make_overlapped_train_step(
            model, lambda m, b: m(b).sum(),
            torch.optim.SGD(model.parameters(), lr=0.1))
        state.topo = ProcessTopology(rank=0, size=2, local_size=2)
        with pytest.raises(RuntimeError,
                           match="layer 'bn_init' \\(5 synced layers"):
            step(torch.rand(2, 32, 32, 3))
        state.topo = topo
        step(torch.rand(2, 32, 32, 3))     # size 1: no allreduce, runs
    finally:
        state.topo = topo
        hvd.shutdown()


# ---------------------------------------------------------------------------
# np=2 through the launcher
# ---------------------------------------------------------------------------

def _resnet_data():
    rng = np.random.RandomState(0)
    x = rng.rand(8, 32, 32, 3).astype(np.float32)
    x[4:] = 2.0 * x[4:] + 1.0   # rank 1's half: other statistics
    y = rng.randint(0, 10, size=(8,)).astype(np.int32)
    return x, y


def _perturb_scales(tree, rng):
    """Random BatchNorm scales: flax zero-inits the last one of each block,
    which would leave the branch's earlier parameters without gradient."""
    return {k: _perturb_scales(v, rng) if isinstance(v, dict) else
            ((1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
             if k == "scale" else np.asarray(v)) for k, v in tree.items()}


def _jax_model(mesh=None):
    return jax_resnet.ResNet(stage_sizes=[1],
                             block_cls=jax_resnet.BottleneckBlock,
                             num_classes=10, num_filters=8, dtype=jnp.float32,
                             fuse_conv1x1_bn=True, fused_bn_mesh=mesh)


def _jax_init():
    x, _ = _resnet_data()
    tx = optax.sgd(LR)
    state = create_train_state(_jax_model(), jax.random.PRNGKey(0),
                               jnp.asarray(x), tx,
                               init_kwargs={"train": True})
    params = _perturb_scales(jax.tree_util.tree_map(np.asarray,
                                                    state.params),
                             np.random.RandomState(1))
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    return params, stats


_WORKER = '''
import json, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.convert import from_flax
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.kernels import synced_matmul_bn_stats
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import cross_entropy_loss

out = sys.argv[1]
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
with open(out + "/init.pkl", "rb") as f:
    init = pickle.load(f)
result = {}

# B8 with summed statistics.
x, w = init["kernel_x"], init["kernel_w"]
rows = slice(16 * rank, 16 * (rank + 1))
xt = torch.from_numpy(x[rows]).requires_grad_()
wt = torch.from_numpy(w).requires_grad_()
y, s1, s2, count = synced_matmul_bn_stats(xt, wt, "test.b8")
mean = s1 / count
var = s2 / count - mean * mean
((y - mean) * torch.rsqrt(var + 1e-5)).sum().backward()
result["kernel"] = {"y": y.detach(), "s1": s1.detach(), "s2": s2.detach(),
                    "count": float(count), "dx": xt.grad, "dw": wt.grad}

# The small fused ResNet: one step synced, one unsynced, from the same
# weights, then a second synced step.
bx, by = init["x"], init["y"]
half = slice(4 * rank, 4 * (rank + 1))
batch = (torch.from_numpy(bx[half]), torch.from_numpy(by[half]).long())
ctl = global_state().controller
for sync in (True, False):
    model = resnet.ResNet(stage_sizes=[1], block_cls=resnet.BottleneckBlock,
                          num_classes=10, num_filters=8,
                          dtype=torch.float32, fuse_conv1x1_bn=True,
                          sync_bn=sync)
    model.load_state_dict(from_flax(init["params"], init["batch_stats"]))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    steps = []
    for step in range(2 if sync else 1):
        before = ctl.serialized_request_count, ctl.cache_hit_count
        opt.zero_grad()
        loss = cross_entropy_loss(model(batch[0]), batch[1])
        loss.backward()
        opt.step()
        steps.append({"loss": float(loss),
                      "serialized": ctl.serialized_request_count - before[0],
                      "hits": ctl.cache_hit_count - before[1],
                      "state": {k: v.clone()
                                for k, v in model.state_dict().items()}})
    result[f"resnet.{sync}"] = steps

# hvd.SyncBatchNorm on NCHW.
rng = np.random.RandomState(11)
gx = rng.randn(8, 4, 5, 5).astype(np.float32)
gx[4:] = 3.0 * gx[4:] - 1.0
gg = rng.randn(8, 4, 5, 5).astype(np.float32)
bn = hvd.SyncBatchNorm(4, momentum=0.3)
with torch.no_grad():
    bn.weight.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
    bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
xt = torch.from_numpy(gx[half]).requires_grad_()
o = bn.train()(xt)
(o * torch.from_numpy(gg[half])).sum().backward()
result["sbn"] = {"out": o.detach(), "dx": xt.grad, "dw": bn.weight.grad,
                 "db": bn.bias.grad, "mean": bn.running_mean,
                 "var": bn.running_var}
hvd.shutdown()
torch.save(result, f"{out}/rank{rank}.pt")
print("WORKER_DONE", rank, flush=True)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("sync_bn_np2")
    x, y = _resnet_data()
    kx, kw = _kernel_inputs()
    params, stats = _jax_init()
    with open(out / "init.pkl", "wb") as f:
        pickle.dump({"x": x, "y": y, "kernel_x": kx, "kernel_w": kw,
                     "params": params, "batch_stats": stats}, f)
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         sys.executable, str(script), str(out)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np=2 job timed out after {JOB_TIMEOUT}s\n{stdout}\n"
                    f"{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def mesh():
    return build_mesh(MeshSpec(data=2), devices=jax.devices()[:2])


def test_synced_b8_matches_the_sharded_jax_kernel(job, mesh):
    x, w = _kernel_inputs()

    def loss(x, w):
        y, s1, s2 = sharded_matmul_bn_stats(x, w, mesh)
        return _bn_loss(y, s1, s2, y.shape[0], jax.lax.rsqrt, jnp.sum)

    yj, s1j, s2j = sharded_matmul_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                           mesh)
    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    yj, gx = np.asarray(yj), np.asarray(gx)
    for r, rank in enumerate(job):
        k = rank["kernel"]
        rows = slice(16 * r, 16 * (r + 1))
        assert k["count"] == x.shape[0]
        np.testing.assert_allclose(k["y"].numpy(), yj[rows], **Y_TOL)
        np.testing.assert_allclose(k["s1"].numpy(), np.asarray(s1j),
                                   **S1_TOL)
        np.testing.assert_allclose(k["s2"].numpy(), np.asarray(s2j),
                                   **S2_TOL)
        np.testing.assert_allclose(k["dx"].numpy(), gx[rows], **GRAD_TOL)
    np.testing.assert_allclose(
        (job[0]["kernel"]["dw"] + job[1]["kernel"]["dw"]).numpy(),
        np.asarray(gw), **GRAD_TOL)
    assert torch.equal(job[0]["kernel"]["s1"], job[1]["kernel"]["s1"])


@pytest.fixture(scope="module")
def jax_step(mesh):
    x, y = _resnet_data()
    params, stats = _jax_init()
    tx = optax.sgd(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=tx.init(jparams),
                       batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                          stats))
    step = make_sharded_train_step(_jax_model(mesh), tx, mesh,
                                   has_batch_stats=True, donate=False)
    state, loss = step(state, shard_batch(mesh, {"x": jnp.asarray(x),
                                                 "y": jnp.asarray(y)}))
    return float(loss), from_flax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats))


def _misses(got: dict, want: dict) -> list:
    out = []
    for key, value in want.items():
        if not np.allclose(got[key].numpy(), value.numpy(), **TOL):
            out.append(key)
    return out


def test_the_synced_resnet_step_matches_the_sharded_jax_step(job, jax_step):
    loss, want = jax_step
    for rank in job:
        step = rank["resnet.True"][0]
        assert set(step["state"]) == set(want)
        assert _misses(step["state"], want) == []
    mean_loss = (job[0]["resnet.True"][0]["loss"]
                 + job[1]["resnet.True"][0]["loss"]) / 2
    np.testing.assert_allclose(mean_loss, loss, rtol=1e-5)
    for key in want:
        assert torch.equal(job[0]["resnet.True"][0]["state"][key],
                           job[1]["resnet.True"][0]["state"][key]), key


def test_the_unsynced_control_misses(job, jax_step):
    _, want = jax_step
    for rank in job:
        missed = _misses(rank["resnet.False"][0]["state"], want)
        # Every BatchNorm's running statistics, and parameters upstream.
        assert "bn_init.mean" in missed and "bn_init.var" in missed
        assert "BottleneckBlock_0.FusedConv1x1BN_0.mean" in missed
        assert "conv_init.kernel" in missed
    # Each rank's local statistics: the running ones differ across ranks.
    assert not torch.equal(job[0]["resnet.False"][0]["state"]["bn_init.mean"],
                           job[1]["resnet.False"][0]["state"]["bn_init.mean"])


def test_the_statistics_allreduces_hit_the_cache_from_step_two(job):
    first, second = job[1]["resnet.True"]
    # The small model's 5 synced layers' forward and backward allreduces
    # and its gradients: sent in step 1, answered from the cache in step 2.
    assert first["serialized"] > 0
    assert second["serialized"] == 0 and second["hits"] == first["hits"] + \
        first["serialized"]
    assert np.isfinite(second["loss"])


def test_sync_batch_norm_matches_batch_norm_over_the_whole_batch(job):
    rng = np.random.RandomState(11)
    gx = rng.randn(8, 4, 5, 5).astype(np.float32)
    gx[4:] = 3.0 * gx[4:] - 1.0
    gg = rng.randn(8, 4, 5, 5).astype(np.float32)

    def run(x, g):
        bn = torch.nn.BatchNorm2d(4, momentum=0.3)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([0.5, 1.0, 1.5, 2.0]))
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
        xt = torch.from_numpy(x).requires_grad_()
        out = bn.train()(xt)
        (out * torch.from_numpy(g)).sum().backward()
        return {"out": out.detach(), "dx": xt.grad, "dw": bn.weight.grad,
                "db": bn.bias.grad, "mean": bn.running_mean,
                "var": bn.running_var}

    whole = run(gx, gg)
    for r, rank in enumerate(job):
        half = slice(4 * r, 4 * (r + 1))
        got = rank["sbn"]
        for key in ("out", "dx"):
            np.testing.assert_allclose(got[key].numpy(),
                                       whole[key][half].numpy(), **TOL)
        for key in ("mean", "var"):
            np.testing.assert_allclose(got[key].numpy(), whole[key].numpy(),
                                       **TOL)
        local = run(gx[half], gg[half])
        assert not np.allclose(local["out"].numpy(), got["out"].numpy(),
                               **TOL)
        assert not np.allclose(local["var"].numpy(), got["var"].numpy(),
                               **TOL)
    for key in ("dw", "db"):
        np.testing.assert_allclose(
            (job[0]["sbn"][key] + job[1]["sbn"][key]).numpy(),
            whole[key].numpy(), **TOL)
