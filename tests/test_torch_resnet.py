"""The slice as a whole: the port's ResNet trained through its runtime
against the JAX package's train step.

Both sides start from the same weights (flax's init, with random BatchNorm
scales so that every parameter gets a gradient, carried across by
``horovod_tpu_torch.convert.from_flax``) and take two SGD-momentum steps on
the same numpy batch.  The JAX side is ``create_train_state`` +
``make_sharded_train_step(mesh=None)``, the fused kernel in Pallas
interpret mode; the port's side is ``hvd.init(device="cpu")`` +
``hvd.DistributedOptimizer``, every gradient going through the runtime's
allreduce.  At np=1 the two are the same computation: Average's postscale
is 1/size = 1.

Tolerance: rtol 1e-4 / atol 1e-5 in fp32.  The convolutions and reductions
sum in a different order in XLA and in PyTorch, and two steps carry those
roundings into the parameters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu.models.training import (
    create_train_state,
    make_sharded_train_step,
)
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.convert import from_flax
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import train_step

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.1


@pytest.fixture
def runtime():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_scales(params, rng):
    """Random BatchNorm scales (flax zero-inits the last one of each block,
    which would leave the branch's earlier parameters without gradient)."""
    def visit(tree):
        return {k: visit(v) if isinstance(v, dict) else
                ((1.0 + 0.2 * rng.randn(*v.shape)).astype(np.float32)
                 if k == "scale" else v)
                for k, v in tree.items()}
    return visit(params)


def _assert_state_matches(model, params, batch_stats, what):
    expected = from_flax(params, batch_stats)
    got = model.state_dict()
    assert set(got) == set(expected), (set(got) ^ set(expected))
    for key, value in expected.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=f"{what}: {key}", **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_two_sgd_steps_match_jax_train_step(runtime, fused):
    rng = np.random.RandomState(0)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    y = np.array([1, 2], np.int32)
    jmodel = jax_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=jax_resnet.BottleneckBlock,
        num_classes=10, num_filters=8, dtype=jnp.float32,
        fuse_conv1x1_bn=fused)
    tx = optax.sgd(LR, momentum=0.9)
    state = create_train_state(jmodel, jax.random.PRNGKey(0), jnp.asarray(x),
                               tx, init_kwargs={"train": True})
    params = _perturb_scales(_numpy_tree(state.params), rng)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    step = make_sharded_train_step(jmodel, tx, mesh=None,
                                   has_batch_stats=True, donate=False)

    model = resnet.ResNet(stage_sizes=[1, 1], block_cls=resnet.BottleneckBlock,
                          num_classes=10, num_filters=8, dtype=torch.float32,
                          fuse_conv1x1_bn=fused)
    model.load_state_dict(from_flax(params,
                                    _numpy_tree(state.batch_stats)))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
        named_parameters=model.named_parameters())
    n_params = len(list(model.parameters()))
    batch_j = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    batch_t = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    before = cuda_backend.stats["allreduce_tensors"]
    for i in range(2):
        state, loss_j = step(state, batch_j)
        loss_t = train_step(model, opt, batch_t)
        np.testing.assert_allclose(loss_t.item(), float(loss_j),
                                   err_msg=f"loss at step {i}", **TOL)
    assert cuda_backend.stats["allreduce_tensors"] - before == 2 * n_params
    _assert_state_matches(model, _numpy_tree(state.params),
                          _numpy_tree(state.batch_stats), "after two steps")
    # Eval mode: running statistics, no kernel statistics.
    logits_j = jmodel.apply({"params": state.params,
                             "batch_stats": state.batch_stats},
                            jnp.asarray(x), train=False)
    with torch.no_grad():
        logits_t = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)


def test_basic_block_resnet_forward_matches_flax():
    """BasicBlock (ResNet18's block) with its stride-2 'SAME' 3x3 and the
    conv_proj/norm_proj shortcut, in train mode."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jmodel = jax_resnet.ResNet(stage_sizes=[1, 1],
                               block_cls=jax_resnet.BasicBlock, num_classes=10,
                               num_filters=8, dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    params = _perturb_scales(_numpy_tree(variables["params"]), rng)
    logits_j, mut = jmodel.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params),
         "batch_stats": variables["batch_stats"]},
        jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = resnet.ResNet(stage_sizes=[1, 1], block_cls=resnet.BasicBlock,
                          num_classes=10, num_filters=8, dtype=torch.float32)
    model.load_state_dict(from_flax(params,
                                    _numpy_tree(variables["batch_stats"])))
    with torch.no_grad():
        logits_t = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    _assert_state_matches(model, params, _numpy_tree(mut["batch_stats"]),
                          "batch statistics")


@pytest.mark.parametrize("fused,launches", [(True, 36), (False, 0)])
def test_resnet50_layout_and_kernel_launch_count(fused, launches):
    """Full-width ResNet-50 structure: the flax parameter layout, and 36
    fused conv1x1+BN modules per forward when fused (the count chip_smoke
    asserts of the kernel on the card)."""
    model = resnet.ResNet50(num_classes=1000, fuse_conv1x1_bn=fused,
                            generator=torch.Generator().manual_seed(0))
    n_fused = sum(isinstance(m, resnet.FusedConv1x1BN)
                  for m in model.modules())
    assert n_fused == launches
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["conv_init.kernel"] == (64, 3, 7, 7)
    assert shapes["Dense_0.kernel"] == (1000, 2048)
    if fused:
        assert shapes["BottleneckBlock_0.fused_proj.kernel"] == (64, 256)
        assert shapes["BottleneckBlock_15.FusedConv1x1BN_1.kernel"] == \
            (512, 2048)
    else:
        assert shapes["BottleneckBlock_0.conv_proj.kernel"] == (256, 64, 1, 1)


def test_fused_flag_only_for_bottleneck_blocks():
    with pytest.raises(ValueError, match="fuse_conv1x1_bn"):
        resnet.ResNet(stage_sizes=[1], block_cls=resnet.BasicBlock,
                      num_filters=8, fuse_conv1x1_bn=True)
