"""The port's Adasum against the JAX package's.

In one process:

- the plain versions of the per-entry arithmetic (``kernels/adasum.py``)
  against the JAX ``_segment_bounds``, ``_partial_triplets`` and
  ``_apply_combine`` on seeded layouts, with windows that cut entries, in
  fp32 and widened bf16; the kernels' tile schedule emulated in torch; the
  zero-norm rule; padding that never enters a norm (fault C5);
- the host plane's op (VHDD) against the JAX ``AdasumAllreduce.execute``
  at P = 2 and 4, and the averaging fallback of both at P = 3, the P ranks
  as threads: the port's on gloo groups over one in-process ``HashStore``,
  the JAX one's over a fake mesh that implements ``sendrecv_into``, the
  one mesh call it makes; both against the fp64 closed-form pairwise tree;
- the device plane's rounds (``XlaAdasum``'s algorithm) on CPU tensors, a
  gloo group in place of the NCCL group, against the closed form and the
  host plane's op; the op chain's choice of plane;
- the delta-space optimizer's refusals, with the JAX bridge's texts.

Across processes, two module-scoped jobs of 60 s at most, both running one
body through the torch surface: the port at np=2 through its launcher and
the JAX package at np=2 through ``tests/helpers.run_distributed`` with the
XLA plane, which also runs ``XlaAdasum`` (fp32 sums, fault C4) on jax
arrays: fused Adasum allreduces with scales, and
``DistributedOptimizer(op=Adasum)`` over SGD and AdamW for two steps.

Limits: 1e-6 relative per entry for fp32 (and fp64) results against the
JAX host plane and the fp64 closed form, one ulp of the dtype for 16-bit
ones (both round once from fp32); 1e-5 against ``XlaAdasum``; 1e-12
relative for the fp64 triplets.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu.torch as jax_torch
from horovod_tpu.backend import adasum as jax_adasum
from horovod_tpu.backend import cpu_ring as jax_cpu_ring
from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import messages as jax_messages
from horovod_tpu.core import state as jax_state
from horovod_tpu.core import tensor_queue as jax_tensor_queue
from horovod_tpu.frameworks.jax import basics as jax_basics
import horovod_tpu_torch as hvd
from horovod_tpu_torch.backend import adasum as port_adasum
from horovod_tpu_torch.common.env import PLANE_HOST, PLANE_NCCL
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core.messages import DataType, Response, ResponseType
from horovod_tpu_torch.core.operation_manager import OperationManager
from horovod_tpu_torch.core.state import register_ops
from horovod_tpu_torch.core.tensor_queue import TensorTableEntry
from horovod_tpu_torch.kernels import adasum as kernels
from horovod_tpu_torch.transport.control import gloo_group

from .helpers import reserve_port, run_distributed
from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
THREAD_TIMEOUT = 60
REL = 1e-6
XLA_REL = 1e-5
TRIPLET_REL = 1e-12
_NP = {"float32": np.float32, "float64": np.float64, "float16": np.float16,
       "bfloat16": ml_dtypes.bfloat16}
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16}
#: One ulp of the 16-bit dtypes at 1.0.
_ULP = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}


def _to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.float32)).to(_TORCH[dtype]) \
        if dtype == "bfloat16" else torch.from_numpy(x.astype(_NP[dtype]))


def _to_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _rel(got, want) -> float:
    got, want = _to_f64(got), _to_f64(want)
    scale = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / scale) if scale else \
        float(np.abs(got).max(initial=0.0))


def _adasum64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    dot, aa, bb = a @ b, a @ a, b @ b
    ca = 1.0 - dot / (2.0 * aa) if aa >= kernels.NORMSQ_EPS else 1.0
    cb = 1.0 - dot / (2.0 * bb) if bb >= kernels.NORMSQ_EPS else 1.0
    return ca * a + cb * b


def _closed_form(per_rank, pre: float = 1.0, post: float = 1.0):
    """The fp64 pairwise tree of VHDD and of the device rounds: ranks
    (0, 1), (2, 3), ... first, then the pairs' results, ``a`` always the
    lower group's; per entry."""
    level = [[_to_f64(x) * pre for x in entries] for entries in per_rank]
    while len(level) > 1:
        level = [[_adasum64(a, b) for a, b in zip(level[i], level[i + 1])]
                 for i in range(0, len(level), 2)]
    return [x * post for x in level[0]]


def _assert_close(got, want, dtype: str, limit: float = REL) -> None:
    """Per entry: within ``limit`` relative for fp32 and fp64; within one
    ulp of the dtype (at the entry's largest magnitude) for 16-bit."""
    for i, (g, w) in enumerate(zip(got, want)):
        if dtype in _ULP:
            g, w = _to_f64(g), _to_f64(w)
            tol = _ULP[dtype] * np.maximum(np.abs(w), 2.0 ** -14)
            assert np.all(np.abs(g - w) <= tol), (i, g, w)
        else:
            assert _rel(g, w) <= limit, (i, _rel(g, w))


# ---------------------------------------------------------------------------
# the plain arithmetic against the JAX helpers
# ---------------------------------------------------------------------------


def _layout(seed: int):
    """Seeded entry sizes (1-element ones among them) and a pair a, b over
    their fused buffer."""
    rng = np.random.RandomState(seed)
    sizes = [int(n) for n in rng.choice([1, 2, 7, 64, 300], rng.randint(3, 9))]
    total = sum(sizes)
    a = (rng.randn(total) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
    b = (rng.randn(total) + 0.5 * a).astype(np.float32)
    return sizes, a, b


def _windows(total: int, seed: int):
    rng = np.random.RandomState(seed + 1)
    cuts = sorted(rng.randint(0, total + 1, 2))
    return [(0, total), (0, total // 2), (total // 2, total),
            (int(cuts[0]), int(cuts[1]) + 1)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_triplets_and_combine_match_the_jax_helpers(seed, dtype):
    """bf16 is widened to fp32 first, as the fused buffer holds it."""
    sizes, a, b = _layout(seed)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        b = b.astype(ml_dtypes.bfloat16).astype(np.float32)
    for lo, hi in _windows(len(a), seed):
        hi = min(hi, len(a))
        segs = port_adasum._segment_bounds(sizes, lo, hi)
        assert segs == jax_adasum._segment_bounds(sizes, lo, hi)
        ta, tb = torch.from_numpy(a[lo:hi].copy()), torch.from_numpy(
            b[lo:hi].copy())
        ours = kernels.triplets(ta, tb, segs, len(sizes))
        theirs = jax_adasum._partial_triplets(a[lo:hi], b[lo:hi], segs,
                                              len(sizes))
        scale = np.sqrt(theirs[:, 1] * theirs[:, 2])[:, None]
        scale = np.maximum(np.abs(theirs), np.where(scale > 0, scale, 1.0))
        assert np.all(np.abs(ours.numpy() - theirs) <= TRIPLET_REL * scale)
        got = kernels.combine(ta, tb, segs, ours)
        want = jax_adasum._apply_combine(a[lo:hi], b[lo:hi], segs, theirs)
        for idx, s_lo, s_hi in segs:
            assert _rel(got[s_lo:s_hi], want[s_lo:s_hi]) <= REL, idx


def test_the_tile_schedule_sums_like_the_plain_version():
    """The kernels' work list (``tile_table``) summed as the two triplet
    kernels sum it (per tile, then the tiles of each entry in order) gives
    the plain triplets; every element of every segment is in exactly one
    tile, and entries outside the window get no tile."""
    sizes = [3, kernels.TILE + 5, 1, 2 * kernels.TILE, 17]
    total = sum(sizes)
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(total).astype(np.float32))
    b = torch.from_numpy(rng.randn(total).astype(np.float32))
    lo, hi = 2, total - 17        # cuts entry 0, leaves out entry 4
    segs = port_adasum._segment_bounds(sizes, lo, hi)
    wa, wb = a[lo:hi], b[lo:hi]
    tiles, entry_ptr = kernels.tile_table(segs, len(sizes))
    assert entry_ptr[0] == 0 and entry_ptr[-1] == tiles.shape[1]
    covered = np.zeros(hi - lo, np.int64)
    partials = []
    for entry, start, end in tiles.T:
        assert 0 < end - start <= kernels.TILE
        covered[start:end] += 1
        x, y = wa[start:end].double(), wb[start:end].double()
        partials.append([float(x @ y), float(x @ x), float(y @ y)])
    want_cover = np.zeros(hi - lo, np.int64)
    for _, s_lo, s_hi in segs:
        want_cover[s_lo:s_hi] = 1
    assert np.array_equal(covered, want_cover)
    partials = np.asarray(partials)
    emulated = np.stack([partials[entry_ptr[e]:entry_ptr[e + 1]].sum(0)
                         for e in range(len(sizes))])
    plain = kernels.triplets_reference(wa, wb, segs, len(sizes)).numpy()
    assert np.allclose(emulated, plain, rtol=TRIPLET_REL, atol=0)
    assert list(np.diff(entry_ptr)) == [1, 2, 1, 2, 0]


def test_zero_norm_rule_agrees_with_xla_greater_than_zero_on_fp32():
    """The fp64 squared norm of an fp32 entry is 0 or at least 2^-298, so
    ``>= sqrt(DBL_MIN)`` picks what ``> 0`` picks: the least subnormal
    entry gets a coefficient, the zero entry passes its peer through."""
    tiny = np.float32(2.0 ** -149)
    a = torch.tensor([tiny, 0, 0, 0, 1.5, -2.0], dtype=torch.float32)
    b = torch.tensor([0, 0, 3.0, 4.0, 1.5, -2.0], dtype=torch.float32)
    segs = [(0, 0, 2), (1, 2, 4), (2, 4, 6)]
    trip = kernels.triplets(a, b, segs, 3)
    assert trip[0, 1] == 2.0 ** -298 and trip[0, 1] >= kernels.NORMSQ_EPS
    for row in trip.tolist():
        for norm in row[1:]:
            assert (norm >= kernels.NORMSQ_EPS) == (norm > 0)
    out = kernels.combine(a, b, segs, trip)
    assert torch.equal(out[2:4], b[2:4])            # adasum(0, g) == g
    assert torch.equal(out[4:6], a[4:6])            # adasum(g, g) == g
    assert kernels.coefficients(trip[0].tolist(), torch.float32)[0] == 1.0


def test_padding_never_enters_the_norms():
    """C5: a window that reaches into the padding counts none of it, however
    large the padding's values, and the padding's output is 0."""
    sizes = [3, 4]
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.randn(10).astype(np.float32))
    b = torch.from_numpy(rng.randn(10).astype(np.float32))
    a[7:], b[7:] = 1e30, -1e30
    segs = port_adasum._segment_bounds(sizes, 5, 10)
    assert segs == [(1, 0, 2)]
    trip = kernels.triplets(a[5:], b[5:], segs, 2)
    want = kernels.triplets(a[5:7], b[5:7], [(1, 0, 2)], 2)
    assert torch.equal(trip, want)
    out = kernels.combine(a[5:], b[5:], segs, trip)
    assert torch.equal(out[2:], torch.zeros(3))


def test_cpu_tensors_take_the_plain_versions_and_cuda_refusals_are_raised():
    """No card here: a CPU pair runs the plain version; a pair of another
    dtype or device the kernels do not take raises before any launch."""
    a = torch.ones(4, dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA device"):
        kernels._check([(0, 0, 4)], a, a)
    before = dict(kernels.LAUNCHES)
    kernels.combine(torch.ones(4), torch.ones(4), [(0, 0, 4)],
                    kernels.triplets(torch.ones(4), torch.ones(4),
                                     [(0, 0, 4)], 1))
    assert kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# the planes' ops, the ranks as threads
# ---------------------------------------------------------------------------


def _threads(size: int, fn):
    """``fn(rank)`` on ``size`` threads; the results in rank order."""
    results, errors = [None] * size, []

    def run(rank):
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(THREAD_TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a rank never finished"
    if errors:
        raise errors[0]
    return results


def _port_op(size: int, plane: str, inputs, dtype: str, pre: float,
             post: float):
    """Every rank's outputs of the port's ``Adasum`` op on ``plane``, with a
    gloo group (the device plane's on CPU tensors, in place of NCCL)."""
    store = dist.HashStore()
    groups = [None] * size

    def rank_fn(rank):
        groups[rank] = gloo_group(dist.PrefixStore("adasum", store), rank,
                                  size, THREAD_TIMEOUT)
        op = port_adasum.Adasum(
            ProcessTopology(rank=rank, size=size, local_size=size),
            torch.device("cpu"), plane, groups[rank])
        entries = [TensorTableEntry(f"t{i}", tensor=_to_torch(x, dtype))
                   for i, x in enumerate(inputs[rank])]
        response = Response(
            ResponseType.ADASUM, [e.tensor_name for e in entries],
            DataType.from_torch(_TORCH[dtype]),
            [e.tensor.numel() for e in entries],
            devices=[0 if plane == PLANE_NCCL else -1],
            prescale_factor=pre, postscale_factor=post)
        assert op.execute(response, entries).ok
        return [e.output for e in entries]

    try:
        return _threads(size, rank_fn)
    finally:
        for group in groups:
            if group is not None:
                group.shutdown()


class _FakeMesh:
    """The JAX mesh's ``sendrecv_into`` between threads."""

    def __init__(self, rank: int, boxes):
        self.rank, self.boxes = rank, boxes

    def sendrecv_into(self, dst, send, src, recv):
        self.boxes[(self.rank, dst)].put(bytes(send))
        data = self.boxes[(src, self.rank)].get(timeout=THREAD_TIMEOUT)
        assert len(data) == len(recv)
        recv[:] = data


def _jax_op(size: int, inputs, dtype: str, pre: float, post: float):
    """Every rank's outputs of the JAX ``AdasumAllreduce.execute``."""
    boxes = collections.defaultdict(queue.Queue)
    for i in range(size):
        for j in range(size):
            boxes[(i, j)] = queue.Queue()

    def rank_fn(rank):
        op = jax_adasum.AdasumAllreduce(
            JaxTopology(rank=rank, size=size, local_size=size),
            _FakeMesh(rank, boxes))
        entries = [jax_tensor_queue.TensorTableEntry(
            f"t{i}", tensor=x.astype(_NP[dtype])) for i, x in
            enumerate(inputs[rank])]
        response = jax_messages.Response(
            jax_messages.ResponseType.ADASUM, [e.tensor_name for e in entries],
            jax_messages.DataType.from_numpy(np.dtype(_NP[dtype])),
            [e.tensor.size for e in entries], prescale_factor=pre,
            postscale_factor=post)
        assert op.execute(response, entries).ok
        return [e.output for e in entries]

    return _threads(size, rank_fn)


def _case(name: str, size: int):
    """(inputs per rank as fp32 numpy, dtype, prescale, postscale)."""
    rng = np.random.RandomState(_CASES.index(name))
    shared = None
    if name == "mixed":           # odd total: padding at every size
        sizes, dtype, pre, post = [5, 1, 33, 2, 64], "float32", 1.0, 1.0
    elif name == "zero":          # rank 0's first entry and all of the second
        sizes, dtype, pre, post = [8, 9], "float32", 0.5, 2.0
    elif name == "identical":     # the same tensors on every rank
        sizes, dtype, pre, post = [10, 3], "float32", 1.0, 1.0
        shared = [rng.randn(n).astype(np.float32) for n in sizes]
    elif name == "fp64":
        sizes, dtype, pre, post = [6, 11], "float64", 1.0, 0.5
    else:                         # bf16, fp16: widened, rounded once
        sizes, dtype, pre, post = [17, 6], name, 0.25, 3.0
    inputs = []
    for rank in range(size):
        entries = shared or [(rng.randn(n) * (i + 1)).astype(np.float32)
                             for i, n in enumerate(sizes)]
        entries = [x.astype(_NP[dtype]).astype(np.float64) for x in entries]
        if name == "zero":
            entries[1][:] = 0
            if rank == 0:
                entries[0][:] = 0
        inputs.append(entries)
    return inputs, dtype, pre, post


_CASES = ["mixed", "zero", "identical", "fp64", "bfloat16", "float16"]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("case", _CASES)
def test_host_plane_vhdd_matches_jax_adasum_allreduce(size, case):
    inputs, dtype, pre, post = _case(case, size)
    ours = _port_op(size, PLANE_HOST, inputs, dtype, pre, post)
    theirs = _jax_op(size, inputs, dtype, pre, post)
    closed = _closed_form(inputs, pre, post)
    for rank in range(size):
        assert all(o.dtype == _TORCH[dtype] for o in ours[rank])
        # Every rank ends with the same bits.
        assert all(torch.equal(o, z) for o, z in zip(ours[rank], ours[0]))
        _assert_close(ours[rank], theirs[rank], dtype)
        _assert_close(ours[rank], closed, dtype)
    if case == "zero":
        assert not ours[0][1].any()
        if size == 2:             # rank 0's zeros pass rank 1's through
            assert torch.equal(ours[0][0], _to_torch(
                inputs[1][0] * pre * post, dtype))
    if case == "identical":
        _assert_close(ours[0], [x for x in inputs[0]], dtype)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("case", _CASES)
def test_device_plane_rounds_match_the_closed_form_and_the_host_plane(
        size, case):
    """``XlaAdasum``'s whole-vector rounds, on CPU tensors over gloo."""
    inputs, dtype, pre, post = _case(case, size)
    ours = _port_op(size, PLANE_NCCL, inputs, dtype, pre, post)
    host = _port_op(size, PLANE_HOST, inputs, dtype, pre, post)
    closed = _closed_form(inputs, pre, post)
    for rank in range(size):
        assert all(torch.equal(o, z) for o, z in zip(ours[rank], ours[0]))
        _assert_close(ours[rank], closed, dtype)
        _assert_close(ours[rank], host[rank], dtype)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_non_power_of_two_averages_and_warns_like_jax(monkeypatch):
    """P = 3: both packages average (the sum with the postscale over the
    size) and warn once with the same text.  The JAX fallback's ring is
    replaced by a recorder of the response it is handed."""
    inputs, dtype, pre, post = _case("mixed", 3)
    handed = []
    monkeypatch.setattr(jax_cpu_ring.RingAllreduce, "execute",
                        lambda self, response, entries: handed.append(
                            response))
    monkeypatch.setattr(jax_adasum.AdasumRingFallback, "_warned", False)
    monkeypatch.setattr(port_adasum.Adasum, "_warned", False)
    jax_log, port_log = _Records(), _Records()
    logging.getLogger("horovod_tpu.backend.adasum").addHandler(jax_log)
    logging.getLogger("horovod_tpu_torch.backend.adasum").addHandler(port_log)
    try:
        jax_op = jax_adasum.AdasumRingFallback(
            JaxTopology(rank=0, size=3, local_size=3), None)
        response = jax_messages.Response(
            jax_messages.ResponseType.ADASUM, ["t"], prescale_factor=pre,
            postscale_factor=post)
        for _ in range(2):
            jax_op.execute(response, [])
        ours = _port_op(3, PLANE_HOST, inputs, dtype, pre, post)
        _port_op(3, PLANE_HOST, inputs, dtype, pre, post)
    finally:
        logging.getLogger("horovod_tpu.backend.adasum").removeHandler(jax_log)
        logging.getLogger("horovod_tpu_torch.backend.adasum").removeHandler(
            port_log)
    assert handed[0].postscale_factor == post / 3
    assert len(jax_log.messages) == 1 and port_log.messages == \
        jax_log.messages
    mean = [sum(inputs[r][i] for r in range(3)) * pre * post / 3
            for i in range(len(inputs[0]))]
    for rank in range(3):
        _assert_close(ours[rank], mean, dtype)


@pytest.mark.parametrize("size,plane,devices,want", [
    (2, PLANE_NCCL, [0], PLANE_NCCL),
    (4, PLANE_NCCL, [0], PLANE_NCCL),
    (3, PLANE_NCCL, [0], PLANE_HOST),     # not a power of two
    (2, PLANE_NCCL, [-1], PLANE_HOST),    # on the CPU on every rank
    (2, PLANE_HOST, [0], PLANE_HOST),
    (1, PLANE_HOST, [-1], "local"),
])
def test_op_chain_gives_the_host_plane_what_the_device_plane_cannot_run(
        size, plane, devices, want):
    manager = OperationManager()
    register_ops(manager, ProcessTopology(rank=0, size=size,
                                          local_size=size),
                 torch.device("cpu"), plane, object(), object())
    response = Response(ResponseType.ADASUM, ["t"], DataType.FLOAT32, [3],
                        devices=devices)
    chain = manager._chains[ResponseType.ADASUM]
    assert all(isinstance(op, port_adasum.Adasum) for op in chain)
    first = next(op for op in chain if op.enabled(response, []))
    assert first.plane == want


# ---------------------------------------------------------------------------
# the optimizer's refusals, with the JAX bridge's texts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runtimes():
    jax_state.reset_global_state()
    jax_basics.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jax_state.reset_global_state()


def _error(fn) -> BaseException:
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — returned to be compared
        return e
    raise AssertionError("expected an error")


def test_adasum_optimizer_refusals_have_the_jax_texts(runtimes):
    p = torch.nn.Parameter(torch.ones(2))
    q = torch.nn.Parameter(torch.ones(2))
    theirs = _error(jax_torch.DistributedOptimizer(
        torch.optim.SGD([q], lr=0.1), op=jax_torch.Adasum).synchronize)
    ours = _error(hvd.DistributedOptimizer(
        torch.optim.SGD([p], lr=0.1), op=hvd.Adasum).synchronize)
    assert isinstance(ours, HorovodInternalError)
    assert str(ours) == str(theirs)
    theirs = _error(lambda: jax_torch.DistributedOptimizer(
        torch.optim.SGD([q], lr=0.1), op=jax_torch.Adasum,
        backward_passes_per_step=2))
    ours = _error(lambda: hvd.DistributedOptimizer(
        torch.optim.SGD([p], lr=0.1), op=hvd.Adasum,
        backward_passes_per_step=2))
    assert type(ours) is type(theirs) is ValueError
    assert str(ours) == str(theirs)


@pytest.mark.parametrize("scale", ["prescale_factor", "postscale_factor"])
def test_adasum_optimizer_refuses_scales(runtimes, scale):
    p = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(ValueError, match=scale):
        hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                 op=hvd.Adasum, **{scale: 0.5})


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.uint8])
def test_integer_adasum_raises_naming_sum_and_average(runtimes, dtype):
    """A deliberate difference (ROADMAP C): the JAX host plane combines an
    integer tensor in floats and casts back."""
    with pytest.raises(ValueError, match="use Sum or Average"):
        hvd.allreduce(torch.ones(3, dtype=dtype), op=hvd.Adasum)
    with pytest.raises(ValueError, match="use Sum or Average"):
        hvd.allreduce_async_(torch.ones(3, dtype=dtype), op=hvd.Adasum)


# ---------------------------------------------------------------------------
# np=2: the port through its launcher, the JAX package beside it
# ---------------------------------------------------------------------------

_PORT_PRELUDE = '''
import os
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
PKG = "port"
'''

_JAX_PRELUDE = '''
import torch
torch.set_num_threads(1)
import jax.numpy as jnp
from horovod_tpu.backend.xla import stats as xla_stats
from horovod_tpu.frameworks.jax import ops as jax_ops
import horovod_tpu.torch as hvd
PKG = "jax"
'''

_BODY = '''
import json
import torch.nn as nn

OUT = os.environ["ADASUM_OUT"]
SIZES = (5, 1, 33, 2, 64)


def vec(kind, i, r, n):
    rng = np.random.RandomState(1000 * kind + 10 * i + r)
    return (rng.randn(n) * (i + 1)).astype(np.float32)


out = {}
# The host plane: fused Adasum allreduces with scales.
for dt in ("float32", "float16"):
    handles = [hvd.allreduce_async(
        torch.from_numpy(vec(1, i, rank, n).astype(dt)), op=hvd.Adasum,
        name=f"fused.{dt}.{i}", prescale_factor=0.5, postscale_factor=3.0)
        for i, n in enumerate(SIZES)]
    for i, h in enumerate(handles):
        out[f"fused.{dt}.{i}"] = hvd.synchronize(h).numpy()

# The delta-space optimizer over a seeded two-layer model, two steps.
for kind in ("sgd", "adamw"):
    rng = np.random.RandomState(5)
    model = nn.Sequential(nn.Linear(5, 6), nn.Tanh(), nn.Linear(6, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                (rng.randn(*p.shape) * 0.5).astype(np.float32)))
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9) \\
        if kind == "sgd" else torch.optim.AdamW(model.parameters(), lr=0.01)
    opt = hvd.DistributedOptimizer(
        inner, named_parameters=[(f"{kind}.{n}", p)
                                 for n, p in model.named_parameters()],
        op=hvd.Adasum)
    data = np.random.RandomState(100 + rank)
    for step in range(2):
        x = torch.from_numpy(data.randn(8, 5).astype(np.float32))
        y = torch.from_numpy(data.randn(8, 3).astype(np.float32))
        opt.zero_grad()
        nn.functional.mse_loss(model(x), y).backward()
        opt.step()
    for n, p in model.named_parameters():
        out[f"{kind}.{n}"] = p.detach().numpy().copy()

if PKG == "jax":
    # XlaAdasum: the device plane's rounds with fp32 sums, on jax arrays.
    handles = [jax_ops.allreduce_async(jnp.asarray(vec(2, i, rank, n)),
                                       op="adasum", name=f"xla.{i}")
               for i, n in enumerate(SIZES)]
    for i, h in enumerate(handles):
        out[f"xla.{i}"] = np.asarray(jax_ops.synchronize(h))
    assert xla_stats.get("adasum", 0) >= 1, xla_stats
else:
    # Rank 0 joins at once: its zeros pass rank 1's tensor through.
    if rank == 0:
        hvd.join()
    else:
        out["joined"] = hvd.allreduce(torch.from_numpy(vec(3, 0, 1, 9)),
                                      op=hvd.Adasum, name="joined").numpy()
        hvd.join()
np.savez(f"{OUT}/{PKG}.rank{rank}.npz", **out)
'''

SIZE = 2
_SIZES = (5, 1, 33, 2, 64)


def _vec(kind: int, i: int, r: int, n: int) -> np.ndarray:
    """``vec`` of ``_BODY``: what each rank sent."""
    rng = np.random.RandomState(1000 * kind + 10 * i + r)
    return (rng.randn(n) * (i + 1)).astype(np.float32)


def _load(out: Path, pkg: str):
    return [dict(np.load(out / f"{pkg}.rank{r}.npz")) for r in range(SIZE)]


@pytest.fixture(scope="module")
def port_np2(tmp_path_factory):
    out = tmp_path_factory.mktemp("adasum_port")
    script = out / "worker.py"
    script.write_text(_PORT_PRELUDE + _BODY + '''
hvd.shutdown()
print("WORKER_DONE", rank)
''')
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60",
               ADASUM_OUT=str(out))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "-np", str(SIZE), sys.executable, str(script)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np={SIZE} job timed out after {JOB_TIMEOUT}s\n"
                    f"{stdout}\n{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    for r in range(SIZE):
        assert f"[{r}]<stdout>: WORKER_DONE {r}" in stdout, stdout
    return _load(out, "port")


@pytest.fixture(scope="module")
def jax_np2(tmp_path_factory):
    out = tmp_path_factory.mktemp("adasum_jax")
    run_distributed(SIZE, _JAX_PRELUDE + _BODY, timeout=45, retries=1,
                    extra_env={"HOROVOD_MESH_STARTUP_TIMEOUT": "60",
                               "HOROVOD_DATA_PLANE": "xla",
                               "HOROVOD_JAX_COORDINATOR":
                                   f"127.0.0.1:{reserve_port()}",
                               "ADASUM_OUT": str(out)})
    return _load(out, "jax")


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_np2_fused_adasum_matches_the_jax_job(port_np2, jax_np2, dtype):
    inputs = [[_vec(1, i, r, n).astype(_NP[dtype]) for i, n in
               enumerate(_SIZES)] for r in range(SIZE)]
    closed = _closed_form(inputs, 0.5, 3.0)
    for r in range(SIZE):
        ours = [port_np2[r][f"fused.{dtype}.{i}"] for i in range(len(_SIZES))]
        theirs = [jax_np2[r][f"fused.{dtype}.{i}"]
                  for i in range(len(_SIZES))]
        assert all(o.dtype == np.dtype(dtype) for o in ours)
        _assert_close(ours, theirs, dtype)
        _assert_close(ours, closed, dtype)


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_np2_adasum_optimizer_matches_the_jax_bridge(port_np2, jax_np2,
                                                     kind):
    keys = [k for k in jax_np2[0] if k.startswith(kind + ".")]
    assert len(keys) == 4
    for r in range(SIZE):
        for key in keys:
            assert np.array_equal(port_np2[r][key], port_np2[0][key]), key
            np.testing.assert_allclose(port_np2[r][key], jax_np2[r][key],
                                       rtol=REL, atol=0, err_msg=key)


def test_np2_a_joined_ranks_zeros_pass_the_peers_tensor_through(port_np2):
    assert np.array_equal(port_np2[1]["joined"], _vec(3, 0, 1, 9))


def test_np2_device_rounds_match_xla_adasum(jax_np2):
    """C4: ``XlaAdasum`` sums in fp32, the port in fp64: within 1e-5."""
    inputs = [[_vec(2, i, r, n) for i, n in enumerate(_SIZES)]
              for r in range(SIZE)]
    ours = _port_op(SIZE, PLANE_NCCL, inputs, "float32", 1.0, 1.0)
    for r in range(SIZE):
        theirs = [jax_np2[r][f"xla.{i}"] for i in range(len(_SIZES))]
        _assert_close(ours[r], theirs, "float32", XLA_REL)
        _assert_close(ours[r], _closed_form(inputs), "float32")
