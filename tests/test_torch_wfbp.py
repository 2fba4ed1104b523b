"""The port's fusion at the source and overlap against the JAX package's.

In one process:

- ``wfbp._fuse_plan``'s dtype groups and ``enqueue_tree_fused``'s wire
  names against ``horovod_tpu/frameworks/jax/wfbp.py`` on mixed-dtype
  trees (lists, tuples and dicts), the collectives replaced by recorders;
- ``ops.synchronize_many`` against the JAX ``HandleManager.wait_many``:
  results in handle order, one deadline for the batch, every handle
  released before an error or a timeout is raised;
- ``DistributedOptimizer(overlap=True)``: the JAX texts of its refusals,
  the window guards (a pass too many, a ``step()`` too early, the abandoned
  window drained without blocking) and a wire root per instance;
- ``distributed_value_and_grad`` at size 1 against the JAX one on the same
  seeded function and inputs (1e-6);
- every knob of ``common/env.py::UNSUPPORTED_KNOBS`` and
  ``TUNING_ONLY_KNOBS``, one case each: ``hvd.init()`` raises naming the
  knob and its slice, or warns.

Across processes, one module-scoped np=2 job of 60 s at most through the
port's launcher on the CPU:

- a fused tree of integer-valued fp32 and bf16 leaves against the per-leaf
  allreduces of the same leaves, bit for bit, one tensor per dtype;
- ``overlap=True`` against ``overlap=False`` and against the numbers of the
  JAX ``test_overlap_matches_accumulate_two_ranks`` body (SGD momentum 0.9,
  which is optax's trace without dampening), within 1e-6;
- ``distributed_value_and_grad`` against the mean of the ranks' local
  gradients (1e-6);
- ``make_overlapped_train_step`` (uncaptured on the CPU, its average on the
  gloo control group) against single-process training on the concatenated
  batch, ``tests/test_wfbp.py:162-207``'s check, within 1e-5;
- its refusals: shapes that diverge across ranks, and the host plane at
  size > 1 on the card (the device swapped to ``cuda`` before any CUDA
  call).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.core import handle_manager as jax_handle_manager
from horovod_tpu.core import state as jax_state
from horovod_tpu.core.tensor_queue import Status as JaxStatus
from horovod_tpu.frameworks.jax import ops as jax_ops
from horovod_tpu.frameworks.jax import optimizer as jax_optimizer
from horovod_tpu.frameworks.jax import wfbp as jax_wfbp
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, optimizer, wfbp
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.core import handle_manager
from horovod_tpu_torch.core.tensor_queue import Status

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60

# ---------------------------------------------------------------------------
# the fused tree
# ---------------------------------------------------------------------------

_LEAVES = [((2, 3), np.float32), ((5,), ml_dtypes.bfloat16),
           ((4,), np.float32), ((3, 1), np.int32), ((2, 2), np.float16),
           ((), ml_dtypes.bfloat16), ((7,), np.float32)]


def _numpy_leaves(seed: int = 0):
    rng = np.random.RandomState(seed)
    return [np.asarray(rng.randn(*shape)).astype(dtype) if dtype != np.int32
            else rng.randint(-9, 9, shape).astype(dtype)
            for shape, dtype in _LEAVES]


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.reshape(-1).view(np.uint16).copy()) \
            .view(torch.bfloat16).reshape(x.shape)
    return torch.from_numpy(np.array(x))


def _trees(leaves):
    """The same leaves as a list, a tuple and a dict whose insertion order
    is its sorted order (jax sorts dict keys, torch keeps insertion)."""
    return {"list": list(leaves), "tuple": tuple(leaves),
            "dict": {f"k{i}": leaf for i, leaf in enumerate(leaves)}}


@pytest.mark.parametrize("kind", ["list", "tuple", "dict"])
def test_fuse_plan_groups_match_jax(kind):
    leaves = _numpy_leaves()
    ours = wfbp._fuse_plan(wfbp.signature([_torch(x) for x in leaves]))
    theirs = jax_wfbp._fuse_plan(tuple(
        (tuple(x.shape), jnp.asarray(x).dtype.name) for x in leaves))[0]
    assert [(dt, list(idxs)) for dt, idxs in theirs] == \
        [(dt, list(idxs)) for dt, idxs in ours.groups]


def _recorder(handles, names):
    """A stand-in ``allreduce_async``: records the name and completes the
    handle at once with the tensor it was given."""
    def fake_async(tensor, name=None, op=None, **kw):
        names.append(name)
        h = handles.allocate()
        handles.mark_done(h, Status.OK() if handles is not jax_ops._handles
                          else JaxStatus.OK(), tensor)
        return h
    return fake_async


@pytest.mark.parametrize("kind", ["list", "tuple", "dict"])
def test_fused_wire_names_and_round_trip_match_jax(kind, monkeypatch):
    leaves = _numpy_leaves(1)
    ours, theirs = [], []
    monkeypatch.setattr(wfbp.ops, "allreduce_async",
                        _recorder(wfbp.ops._handles, ours))
    monkeypatch.setattr(jax_wfbp.ops, "allreduce_async",
                        _recorder(jax_ops._handles, theirs))
    tree = _trees([_torch(x) for x in leaves])[kind]
    out = wfbp.wait_tree(wfbp.enqueue_tree_fused(
        tree, hvd.Average, name_prefix="grad.opt7.mb1"))
    jax_wfbp.wait_tree(jax_wfbp.enqueue_tree_fused(
        _trees([jnp.asarray(x) for x in leaves])[kind], "average",
        jax_optimizer.Compression.none, 1.0, 1.0,
        name_prefix="grad.opt7.mb1"))
    assert ours == theirs
    assert ours[0] == "grad.opt7.mb1.fused.float32.17"
    # The tree comes back in its own shape, each leaf a view of its
    # dtype's buffer, the same bits.
    flat = list(out.values()) if kind == "dict" else list(out)
    assert type(out) is type(tree)
    for got, want in zip(flat, leaves):
        assert tuple(got.shape) == want.shape
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        assert got.numpy().tobytes() == want.tobytes()


def test_a_fused_buffer_is_a_copy():
    """A microbatch's buffer may be in flight while the next backward
    writes ``p.grad``: flatten never hands out a view of a leaf."""
    leaf = torch.ones(4)
    plan = wfbp._fuse_plan(wfbp.signature([leaf]))
    (buf,) = plan.flatten([leaf])
    leaf.zero_()
    assert buf.tolist() == [1.0] * 4


# ---------------------------------------------------------------------------
# synchronize_many
# ---------------------------------------------------------------------------


def _managers():
    return [(handle_manager.HandleManager(), Status, HorovodInternalError),
            (jax_handle_manager.HandleManager(), JaxStatus,
             jax_handle_manager.HorovodInternalError)]


@pytest.mark.parametrize("case", ["ok", "error", "timeout", "unknown"])
def test_wait_many_matches_jax(case):
    outcomes = []
    for mgr, status, internal in _managers():
        hs = [mgr.allocate() for _ in range(4)]
        for i, h in enumerate(hs):
            if case == "error" and i == 1:
                mgr.mark_done(h, status.error("rank 1 failed"), None)
            elif case == "timeout" and i >= 2:
                continue        # never completes
            else:
                mgr.mark_done(h, status.OK(), f"r{i}")
        t0 = time.monotonic()
        try:
            if case == "unknown":
                mgr.wait_many(hs + [999])
            outcomes.append(("ok", mgr.wait_many(hs, timeout=0.3)))
        except internal as e:
            outcomes.append(("internal", str(e)))
        except TimeoutError:
            outcomes.append(("timeout", None))
        except ValueError as e:
            outcomes.append(("value", str(e)))
        waited = time.monotonic() - t0
        if case == "timeout":
            # One deadline for the whole batch, not one per handle.
            assert 0.25 <= waited < 0.55, waited
        if case != "unknown":
            # Every handle released, whatever the outcome.
            assert not any(h in mgr._events or h in mgr._done for h in hs)
    assert outcomes[0] == outcomes[1]
    expected = {"ok": "ok", "error": "internal", "timeout": "timeout",
                "unknown": "value"}[case]
    assert outcomes[0][0] == expected
    if case == "ok":
        assert outcomes[0][1] == ["r0", "r1", "r2", "r3"]


def test_synchronize_many_returns_results_in_handle_order():
    hvd.init(device="cpu")
    try:
        hs = [hvd.allreduce_async(torch.full((3,), float(i)), name=f"sm.{i}")
              for i in range(5)]
        out = hvd.synchronize_many(list(reversed(hs)))
        assert [t.tolist() for t in out] == [[float(i)] * 3
                                             for i in reversed(range(5))]
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# DistributedOptimizer(overlap=True)
# ---------------------------------------------------------------------------


def _jax_refusal(**kwargs) -> str:
    with pytest.raises(ValueError) as err:
        jax_optimizer.DistributedOptimizer(optax.sgd(0.1), **kwargs)
    return str(err.value)


def test_overlap_refusals_have_the_jax_texts():
    p = torch.nn.Parameter(torch.zeros(2))
    for kwargs in ({"overlap": True},
                   {"op": "adasum", "backward_passes_per_step": 2,
                    "overlap": True},
                   {"op": "adasum", "overlap": True}):
        with pytest.raises(ValueError) as err:
            hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1), **kwargs)
        want = _jax_refusal(**kwargs)
        if "optax.MultiSteps" in want:     # the one optax-specific hint
            assert str(err.value).split(";")[0] == want.split(";")[0]
        else:
            assert str(err.value) == want


@pytest.fixture
def size_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _overlap_opt(bpps: int = 2):
    w = torch.nn.Parameter(torch.zeros(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   named_parameters=[("w", w)],
                                   backward_passes_per_step=bpps,
                                   overlap=True)
    return w, opt


def _wait_drained(handles, limit: float = 10.0) -> bool:
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        with hvd.ops._handles._lock:
            if not any(h in hvd.ops._handles._events for h in handles):
                return True
        time.sleep(0.05)
    return False


def test_a_pass_too_many_abandons_the_window(size_one):
    w, opt = _overlap_opt(2)
    for _ in range(2):
        (w * 2.0).sum().backward()
    handles = [h for tree in opt._window for h in tree.handles]
    with pytest.raises(HorovodInternalError, match="overlap window desync"):
        (w * 2.0).sum().backward()
    assert opt._window == []
    assert _wait_drained(handles)
    # The next window runs.
    for _ in range(2):
        (w * 3.0).sum().backward()
    opt.step()
    assert w.grad.tolist() == [3.0] * 3


def test_an_early_step_abandons_the_window_without_blocking(size_one,
                                                             monkeypatch):
    w, opt = _overlap_opt(3)
    (w * 2.0).sum().backward()
    handles = [h for tree in opt._window for h in tree.handles]
    t0 = time.monotonic()
    with pytest.raises(HorovodInternalError,
                       match="step\\(\\) after 1 backward passes"):
        opt.step()
    assert time.monotonic() - t0 < 0.5
    assert _wait_drained(handles)
    assert any(t.name == "hvd-window-drainer" for t in threading.enumerate()) \
        or optimizer._drain_thread is None


def test_the_drainer_drops_a_handle_that_never_completes(size_one):
    stuck = hvd.ops._handles.allocate()
    t0 = time.monotonic()
    optimizer._drain_handles_async([stuck], timeout_s=0.3)
    assert time.monotonic() - t0 < 0.2
    assert _wait_drained([stuck])


def test_overlap_zeroes_the_gradient_after_each_pass(size_one):
    w, opt = _overlap_opt(2)
    (w * 2.0).sum().backward()
    assert w.grad.tolist() == [0.0] * 3
    (w * 4.0).sum().backward()
    opt.step()
    assert w.grad.tolist() == [3.0] * 3


def test_optimizer_instances_get_distinct_wire_roots(size_one, monkeypatch):
    names = []
    real = wfbp.ops.allreduce_async

    def recording(tensor, name=None, **kw):
        names.append(name)
        return real(tensor, name=name, **kw)

    monkeypatch.setattr(wfbp.ops, "allreduce_async", recording)
    roots = []
    for _ in range(2):
        names.clear()
        w, opt = _overlap_opt(2)
        for _ in range(2):
            (w * 1.0).sum().backward()
        opt.step()
        roots.append({n.split(".mb")[0] for n in names})
        assert [n.split(".", 3)[-1] for n in names] == \
            ["fused.float32.3"] * 2
        assert [n.split(".")[2] for n in names] == ["mb0", "mb1"]
    assert len(roots[0]) == len(roots[1]) == 1
    assert roots[0].isdisjoint(roots[1])
    assert all(r.startswith("grad.opt") for s in roots for r in s)


# ---------------------------------------------------------------------------
# distributed_value_and_grad
# ---------------------------------------------------------------------------


def test_distributed_value_and_grad_matches_jax(size_one):
    import jax

    from horovod_tpu.frameworks.jax import basics as jax_basics

    rng = np.random.RandomState(3)
    w1, w2 = rng.randn(4, 8).astype(np.float32) * 0.3, \
        rng.randn(8, 2).astype(np.float32) * 0.3
    x, y = rng.randn(6, 4).astype(np.float32), rng.randn(6, 2).astype(
        np.float32)

    def torch_loss(p, x, y):
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    def jax_loss(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    params = {"w1": torch.tensor(w1, requires_grad=True),
              "w2": torch.tensor(w2, requires_grad=True)}
    value, grads = hvd.distributed_value_and_grad(torch_loss)(
        params, torch.tensor(x), torch.tensor(y))
    # A fresh JAX runtime, replaced again after: a shut-down one would
    # leave the next file's init in this process a no-op.
    jax_state.reset_global_state()
    jax_basics.init()
    try:
        jvalue, jgrads = jax_optimizer.distributed_value_and_grad(jax_loss)(
            {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}, jnp.asarray(x),
            jnp.asarray(y))
    finally:
        jax_state.reset_global_state()
    assert set(grads) == {"w1", "w2"}
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(),
                                   np.asarray(jax.device_get(jgrads[k])),
                                   rtol=1e-6, atol=1e-7)
    # Adasum takes the per-leaf path; at size 1 it is the identity.
    _, adasum = hvd.distributed_value_and_grad(torch_loss, op=hvd.Adasum)(
        params, torch.tensor(x), torch.tensor(y))
    for k in grads:
        assert torch.equal(adasum[k], grads[k])


# ---------------------------------------------------------------------------
# the knobs the port does not act on (fault C6)
# ---------------------------------------------------------------------------

_SET = {env_mod.HOROVOD_TIMELINE: "/tmp/trace.json",
        env_mod.HOROVOD_AUTOTUNE_LOG: "/tmp/autotune.csv",
        env_mod.HOROVOD_AUTOTUNE_WARMUP_SAMPLES: "3",
        env_mod.HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE: "10",
        env_mod.HOROVOD_METRICS_PUSH_SECS: "5",
        env_mod.HOROVOD_WIRE_COMPRESSION: "int8",
        env_mod.HOROVOD_NEGOTIATION_FANIN_DIR: "/tmp/fanin",
        env_mod.HOROVOD_NEGOTIATION_FANIN_HEARTBEAT_SECS: "1.0",
        env_mod.HOROVOD_NEGOTIATION_FANIN_VETO_EPOCHS: "2",
        env_mod.HOROVOD_CONTROLLER_TOPOLOGY: "tree",
        env_mod.HOROVOD_TRANSPORT: "shm"}


@pytest.fixture
def clean_knobs(monkeypatch):
    for name, _, _ in env_mod.UNSUPPORTED_KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name in env_mod.TUNING_ONLY_KNOBS + (env_mod.HOROVOD_JAX_COORDINATOR,):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("knob,where", [
    (name, where) for name, _, where in env_mod.UNSUPPORTED_KNOBS])
def test_an_unsupported_knob_raises_at_init(clean_knobs, knob, where):
    clean_knobs.setenv(knob, _SET.get(knob, "1"))
    with pytest.raises(ValueError) as err:
        hvd.init(device="cpu")
    assert knob in str(err.value) and where in str(err.value)
    assert not hvd.is_initialized()


@pytest.mark.parametrize("knob,value", [
    (env_mod.HOROVOD_HIERARCHICAL_ALLREDUCE, "0"),
    (env_mod.HOROVOD_WIRE_COMPRESSION, "none"),
    (env_mod.HOROVOD_AUTOTUNE, "0"),
    (env_mod.HOROVOD_CONTROLLER_TOPOLOGY, "star"),
    (env_mod.HOROVOD_NEGOTIATION_FANIN, "auto")])
def test_a_knob_set_to_what_the_port_does_is_accepted(clean_knobs, knob,
                                                      value):
    clean_knobs.setenv(knob, value)
    hvd.init(device="cpu")
    hvd.shutdown()


def test_the_jax_coordinator_names_the_device_plane(clean_knobs):
    clean_knobs.setenv(env_mod.HOROVOD_JAX_COORDINATOR, "127.0.0.1:1234")
    with pytest.raises(ValueError,
                       match="HOROVOD_JAX_COORDINATOR.*HOROVOD_DATA_PLANE="
                             "nccl"):
        hvd.init(device="cpu")


def test_every_jax_knob_is_read_refused_warned_or_tooling_only():
    """Each ``HOROVOD_*`` name of ``horovod_tpu/common/env.py`` falls in
    exactly one class: (a) the port reads it (its constant is used outside
    ``common/env.py``), (b) ``hvd.init()`` refuses it naming its slice,
    (c) it is warned about as tuning-only, (d) the JAX package reads it
    only in tooling no slice brings (``JAX_TOOLING_ONLY_KNOBS``)."""
    import re

    from horovod_tpu.common import env as jax_env

    jax_names = {v for k, v in vars(jax_env).items()
                 if k.startswith("HOROVOD_") and isinstance(v, str)}
    consts = {v: k for k, v in vars(env_mod).items()
              if k.startswith("HOROVOD_") and isinstance(v, str)}
    package = REPO / "horovod_tpu_torch"
    sources = "\n".join(p.read_text() for p in package.rglob("*.py")
                        if p != package / "common" / "env.py")
    read = {v for v, k in consts.items()
            if re.search(rf"\b{k}\b", sources)}
    refused = {n for n, _, _ in env_mod.UNSUPPORTED_KNOBS} | {
        env_mod.HOROVOD_JAX_COORDINATOR}
    classes = [read, refused, set(env_mod.TUNING_ONLY_KNOBS),
               set(env_mod.JAX_TOOLING_ONLY_KNOBS)]
    for name in sorted(jax_names):
        assert sum(name in c for c in classes) == 1, name


@pytest.mark.parametrize("knob", env_mod.TUNING_ONLY_KNOBS)
def test_a_tuning_only_knob_warns_once(clean_knobs, knob):
    warnings = []
    clean_knobs.setattr(basics.log, "warning",
                        lambda msg, *args: warnings.append(msg % args))
    clean_knobs.setenv(knob, "4")
    hvd.init(device="cpu")
    hvd.shutdown()
    assert len(warnings) == 1 and knob in warnings[0]


# ---------------------------------------------------------------------------
# np=2 through the launcher
# ---------------------------------------------------------------------------

# The JAX ``test_overlap_matches_accumulate_two_ranks`` body's gradients.
OVERLAP_BODY = '''
def microbatch_grads(rank, mb):
    return {"w": [[float(rank + 1 + mb)] * 3] * 2,
            "b": [float(10 * rank + mb)] * 3}
'''
exec(OVERLAP_BODY)

# tests/test_wfbp.py:162-207's data.
STEP_DATA = '''
import numpy as np

def step_data():
    rng = np.random.RandomState(7)
    w1 = (rng.randn(4, 8) * 0.3).astype(np.float32)
    w2 = (rng.randn(8, 2) * 0.3).astype(np.float32)
    x = rng.randn(4, 6, 4).astype(np.float32)
    y = rng.randn(4, 6, 2).astype(np.float32)
    return w1, w2, x, y
'''
exec(STEP_DATA)

_WORKER = OVERLAP_BODY + STEP_DATA + '''
import json, sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import wfbp
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.core.state import global_state

hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
info = {}


def bits(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes().hex()


# A fused tree of integer-valued fp32 and bf16 leaves against the per-leaf
# allreduces of the same leaves.
rng = np.random.RandomState(10 + rank)
tree = {"a": torch.from_numpy(rng.randint(-50, 50, (3, 4)).astype(np.float32)),
        "b": torch.from_numpy(rng.randint(-50, 50, 7).astype(np.float32))
        .to(torch.bfloat16),
        "c": torch.from_numpy(rng.randint(-50, 50, 5).astype(np.float32))}
for op in (hvd.Sum, hvd.Average):
    before = cuda_backend.stats["allreduce_tensors"]
    fused = wfbp.wait_tree(wfbp.enqueue_tree_fused(
        tree, op, name_prefix=f"int.{op}"))
    info[f"fused_tensors.{op}"] = cuda_backend.stats["allreduce_tensors"] \\
        - before
    leaf = {k: hvd.allreduce(v, op=op, name=f"leaf.{op}.{k}")
            for k, v in tree.items()}
    info[f"fused.{op}"] = {k: bits(v) for k, v in fused.items()}
    info[f"leaf.{op}"] = {k: bits(v) for k, v in leaf.items()}

# overlap=True against overlap=False on the JAX body's gradients.
for overlap in (False, True):
    w = torch.nn.Parameter(torch.arange(6, dtype=torch.float32).reshape(2, 3))
    b = torch.nn.Parameter(torch.ones(3))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([w, b], lr=0.1, momentum=0.9),
        named_parameters=[("w", w), ("b", b)], backward_passes_per_step=3,
        overlap=overlap)
    before = cuda_backend.stats["allreduce_tensors"]
    for step in range(2):
        for mb in range(3):
            g = microbatch_grads(rank, mb)
            ((w * torch.tensor(g["w"])).sum()
             + (b * torch.tensor(g["b"])).sum()).backward()
        opt.step()
        opt.zero_grad()
    info[f"overlap.{overlap}"] = {"w": w.tolist(), "b": b.tolist(),
        "tensors": cuda_backend.stats["allreduce_tensors"] - before}

# distributed_value_and_grad on this rank's data.
w1, w2, x, y = step_data()
params = {"w1": torch.tensor(w1, requires_grad=True),
          "w2": torch.tensor(w2, requires_grad=True)}


def loss(p, x, y):
    return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()


xs, ys = torch.tensor(x[0, 3 * rank:3 * rank + 3]), \\
    torch.tensor(y[0, 3 * rank:3 * rank + 3])
value, grads = hvd.distributed_value_and_grad(loss)(params, xs, ys)
local = torch.autograd.grad(loss(params, xs, ys), [params["w1"], params["w2"]])
info["vg"] = {"value": value.item(),
              "grads": {k: g.tolist() for k, g in grads.items()},
              "local": [g.tolist() for g in local]}


# make_overlapped_train_step on half-batches.
class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.tensor(w1))
        self.w2 = torch.nn.Parameter(torch.tensor(w2))


def step_loss(model, batch):
    pred = torch.tanh(batch["x"] @ model.w1) @ model.w2
    return ((pred - batch["y"]) ** 2).mean()


net = Net()
train = hvd.make_overlapped_train_step(
    net, step_loss, torch.optim.SGD(net.parameters(), lr=0.1, momentum=0.9))
lo = 3 * rank
info["losses"] = [train({"x": torch.tensor(x[i, lo:lo + 3]),
                         "y": torch.tensor(y[i, lo:lo + 3])}).item()
                  for i in range(4)]
info["step"] = {"w1": net.w1.tolist(), "w2": net.w2.tolist()}

# The host plane at size > 1 on the card: refused before any CUDA call.
# (Before the last collective: a rank that finished early would stop the
# other's runtime with its shutdown.)
state = global_state()
device, state.device = state.device, torch.device("cuda", 0)
try:
    train({"x": torch.tensor(x[0, lo:lo + 3]),
           "y": torch.tensor(y[0, lo:lo + 3])})
    info["host_plane"] = ""
except RuntimeError as e:
    info["host_plane"] = str(e)
finally:
    state.device = device

# Shapes that diverge across ranks.
odd = torch.nn.Module()
odd.w = torch.nn.Parameter(torch.ones(4, 2 if rank == 0 else 3))
try:
    hvd.make_overlapped_train_step(
        odd, lambda m, b: (b @ m.w).pow(2).mean(),
        torch.optim.SGD(odd.parameters(), lr=0.1))(torch.ones(2, 4))
    info["diverged"] = ""
except RuntimeError as e:
    info["diverged"] = str(e)

hvd.shutdown()
with open(f"{sys.argv[1]}/rank{rank}.json", "w") as f:
    json.dump(info, f)
print("WORKER_DONE", rank)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("wfbp_np2")
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
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("op", ["sum", "average"])
def test_fused_tree_bit_equal_to_per_leaf(job, op):
    for info in job:
        assert info[f"fused.{op}"] == info[f"leaf.{op}"]
        assert info[f"fused.{op}"] == job[0][f"fused.{op}"]
        # One tensor per dtype: fp32 and bf16.
        assert info[f"fused_tensors.{op}"] == 2


def _jax_overlap_numbers(monkeypatch):
    """The JAX body's result: its optimizer, the runtime off (local
    aggregation), fed the two ranks' mean gradients per microbatch."""
    monkeypatch.setattr(jax_optimizer.ops, "initialized", lambda: False)
    params = {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
              "b": jnp.ones(3, jnp.float32)}
    dopt = jax_optimizer.DistributedOptimizer(
        optax.sgd(0.1, momentum=0.9), backward_passes_per_step=3)
    st, p = dopt.init(params), params
    for _ in range(2):
        for mb in range(3):
            g = {k: (jnp.asarray(microbatch_grads(0, mb)[k])
                     + jnp.asarray(microbatch_grads(1, mb)[k])) / 2
                 for k in params}
            upd, st = dopt.update(g, st, p)
            p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("overlap", ["False", "True"])
def test_overlap_matches_accumulate_and_the_jax_body(job, overlap,
                                                     monkeypatch):
    theirs = _jax_overlap_numbers(monkeypatch)
    for info in job:
        got = info[f"overlap.{overlap}"]
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], theirs[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[k], info["overlap.False"][k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        # overlap: one fused tensor per microbatch; accumulate: one per
        # parameter per window.
        assert got["tensors"] == (6 if overlap == "True" else 4)


def test_distributed_value_and_grad_is_the_mean_of_local_grads(job):
    for info in job:
        for i, k in enumerate(("w1", "w2")):
            mean = (np.asarray(job[0]["vg"]["local"][i])
                    + np.asarray(job[1]["vg"]["local"][i])) / 2
            np.testing.assert_allclose(info["vg"]["grads"][k], mean,
                                       rtol=1e-6, atol=1e-7)
    assert job[0]["vg"]["grads"] == job[1]["vg"]["grads"]


def test_overlapped_step_matches_big_batch_training(job):
    w1, w2, x, y = step_data()
    w1, w2 = torch.nn.Parameter(torch.tensor(w1)), \
        torch.nn.Parameter(torch.tensor(w2))
    opt = torch.optim.SGD([w1, w2], lr=0.1, momentum=0.9)
    for i in range(4):
        opt.zero_grad()
        pred = torch.tanh(torch.tensor(x[i]) @ w1) @ w2
        ((pred - torch.tensor(y[i])) ** 2).mean().backward()
        opt.step()
    for info in job:
        np.testing.assert_allclose(info["step"]["w1"], w1.tolist(),
                                   atol=1e-5)
        np.testing.assert_allclose(info["step"]["w2"], w2.tolist(),
                                   atol=1e-5)
    assert job[0]["step"] == job[1]["step"]
    assert job[0]["losses"] != job[1]["losses"]     # each rank's own half


def test_overlapped_step_refuses_diverged_shapes(job):
    for info in job:
        assert info["diverged"].startswith(
            "overlapped train step diverged across ranks: this rank traced")


def test_overlapped_step_refuses_the_host_plane_on_the_card(job):
    for info in job:
        assert "HOROVOD_DATA_PLANE=nccl" in info["host_plane"]
        assert "DistributedOptimizer(overlap=True)" in info["host_plane"]
