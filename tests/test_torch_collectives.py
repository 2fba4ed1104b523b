"""The port's broadcast, allgather, alltoall, join and barrier, and the
functions built on them, against the JAX package.

In one process: seeded request sets of every new type, with a root-rank
mismatch, an allgather trailing-dimension mismatch, alltoall splits of the
wrong length and of the wrong sum, and ranks that have joined, go through
both controllers' ``_increment`` → ``_construct_response`` →
``_fuse_responses`` (both caches off) and through whole coordinator rounds
over fake transports in which a JOIN lands after a tensor's last request
(both with the response cache off and on): the responses must be equal
field by field, and the request and response frames byte for byte.  The
np=1 API runs beside the JAX bridge (``horovod_tpu.torch``) on the same
inputs.  The size > 1 op chain, built with fake groups, runs each
collective on the plane that the negotiated devices call for.

Across processes: two jobs, each run once per module and read by many
tests: the port at np=3 through its launcher, and the JAX package at np=3
through ``tests/helpers.run_distributed``, both running the same body
(``_BODY``) through the torch surface.  The bridge's ``synchronize`` cannot
hand a bf16 result back (``torch.from_numpy`` has no bf16), so the JAX
body sends bf16 through the bridge's core ops (``frameworks/jax/ops.py``),
which the bridge calls for every other dtype.  Broadcast, allgather and
alltoall move bits: every dtype must be bit-exact against the JAX job.
The allreduce with a joined rank adds one rank's zeros to two addends,
which rounds once in any order: equal bits too.  Every job has a 60 s
limit and gloo timeouts of 60 s.
"""

from __future__ import annotations

import inspect
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu.torch as jax_torch
from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import controller as jax_controller
from horovod_tpu.core import messages as jax_messages
from horovod_tpu.core import state as jax_state
from horovod_tpu.frameworks.jax import basics as jax_basics
from horovod_tpu.frameworks.jax import ops as jax_ops
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.env import PLANE_HOST, PLANE_NCCL
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller, messages
from horovod_tpu_torch.core.operation_manager import OperationManager
from horovod_tpu_torch.core.state import register_ops
from horovod_tpu_torch.core.tensor_queue import TensorTableEntry

from .helpers import run_distributed
from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
GLOO_TIMEOUT = "60"
#: Small enough that a cycle's tensors fill more than one bucket.
FUSION_BYTES = 512
JOIN = controller.JOIN_TENSOR_NAME

# ---------------------------------------------------------------------------
# negotiation in one process
# ---------------------------------------------------------------------------

_KINDS = ["BROADCAST", "ALLGATHER", "ALLTOALL", "ALLREDUCE", "BARRIER"]
_DTYPES = ["FLOAT32", "BFLOAT16", "INT32", "UINT8"]
_MISMATCHES = ["root", "trailing", "splits_len", "splits_sum"]


def _request_sets(seed: int, size: int, joined: bool):
    """Per rank, 20 tensors, at least three of each kind, in a
    rank-specific order;
    allgathers have ragged first dimensions, alltoalls uneven splits.  On
    one rank (not rank 0) a broadcast's root, an allgather's trailing
    dimensions and two alltoalls' splits disagree.  With ``joined`` the
    last rank sends a JOIN and nothing else; its list comes first."""
    rng = np.random.RandomState(seed)
    spec = {}
    for i in range(20):
        kind = _KINDS[i % len(_KINDS)] if i < 15 else \
            _KINDS[rng.randint(len(_KINDS))]
        fields = dict(request_type=kind,
                      tensor_type=_DTYPES[rng.randint(len(_DTYPES))],
                      tensor_shape=[int(d) for d in rng.randint(
                          1, 6, rng.randint(1, 4))],
                      device=int(rng.choice([-1, 0])))
        if kind == "ALLGATHER":
            # Fusible with one another: one dtype, device and row width.
            fields.update(tensor_type="FLOAT32", tensor_shape=[1, 2],
                          device=0)
        if kind == "BARRIER":
            fields = dict(request_type=kind)
        if kind == "BROADCAST":
            fields["root_rank"] = int(rng.randint(size))
        spec[f"t{i}"] = fields
    kinds = {"root": "BROADCAST", "trailing": "ALLGATHER",
             "splits_len": "ALLTOALL", "splits_sum": "ALLTOALL"}
    bad, taken = {}, set()
    for mismatch in _MISMATCHES:
        name = next(n for n, f in spec.items()
                    if f["request_type"] == kinds[mismatch] and n not in taken)
        taken.add(name)
        bad[name] = mismatch
    active = size - 1 if joined else size
    bad_rank = 1 + seed % (active - 1)
    per_rank = []
    for rank in range(size):
        if joined and rank == size - 1:
            per_rank.append([dict(request_rank=rank, request_type="JOIN",
                                  tensor_name=JOIN)])
            continue
        reqs = []
        for name in rng.permutation(list(spec)):
            fields = dict(spec[name], request_rank=rank,
                          tensor_name=str(name))
            kind = fields["request_type"]
            shape = list(fields.get("tensor_shape", []))
            if kind == "ALLGATHER":
                shape[0] = int(rng.randint(0, 5))
            if kind == "ALLTOALL":
                fields["splits"] = [int(n) for n in rng.randint(0, 4, size)]
                shape[0] = sum(fields["splits"])
            if kind != "BARRIER":
                fields["tensor_shape"] = shape
            if rank == bad_rank and name in bad:
                mismatch = bad[name]
                if mismatch == "root":
                    fields["root_rank"] = (fields["root_rank"] + 1) % size
                elif mismatch == "trailing":
                    fields["tensor_shape"] = shape + [2]
                elif mismatch == "splits_len":
                    fields["splits"] = fields["splits"] + [0]
                else:
                    fields["splits"] = [fields["splits"][0] + 1] \
                        + fields["splits"][1:]
            reqs.append(fields)
        per_rank.append(reqs)
    if joined:
        # The JOIN is tallied first, so each tensor completes on the last
        # request of the ranks still active.
        per_rank.insert(0, per_rank.pop())
    return per_rank


def _request(mod, fields: dict):
    return mod.Request(**{
        **fields, "request_type": mod.RequestType[fields["request_type"]],
        "tensor_type": mod.DataType[fields.get("tensor_type", "FLOAT32")]})


def _fields(resp) -> dict:
    return {"response_type": resp.response_type.name,
            "tensor_names": list(resp.tensor_names),
            "tensor_type": resp.tensor_type.name,
            "tensor_sizes": list(resp.tensor_sizes),
            "error_message": resp.error_message,
            "devices": list(resp.devices),
            "prescale_factor": resp.prescale_factor,
            "postscale_factor": resp.postscale_factor,
            "last_joined_rank": resp.last_joined_rank}


def _topologies(size: int):
    return (ProcessTopology(rank=0, size=size, local_size=size),
            JaxTopology(rank=0, size=size, local_size=size))


class _Unused:
    """The control plane of a controller driven method by method."""


def _drive(ctl, mod, per_rank) -> list:
    ready = []
    for reqs in per_rank:
        for fields in reqs:
            if ctl._increment(_request(mod, fields)):
                ready.append(fields["tensor_name"])
    responses = [ctl._construct_response(name) for name in ready]
    return [_fields(r) for r in
            ctl._fuse_responses([r for r in responses if r is not None])]


@pytest.mark.parametrize("size,joined", [(2, False), (3, False), (4, False),
                                         (3, True), (4, True)])
@pytest.mark.parametrize("seed", range(3))
def test_responses_match_jax_controller(seed, size, joined):
    ours_topo, jax_topo = _topologies(size)
    per_rank = _request_sets(seed, size, joined)
    ours = _drive(controller.Controller(ours_topo, _Unused(),
                                        fusion_threshold_bytes=FUSION_BYTES,
                                        cache_capacity=0),
                  messages, per_rank)
    theirs = _drive(jax_controller.Controller(
        jax_topo, None, fusion_threshold_bytes=FUSION_BYTES, cache_capacity=0),
        jax_messages, per_rank)
    assert ours == theirs
    errors = {r["error_message"].split(" for ")[0] for r in ours
              if r["response_type"] == "ERROR"}
    assert {"Mismatched broadcast root ranks",
            "Mismatched allgather tensor shapes"} <= errors
    kinds = {r["response_type"] for r in ours}
    # With a joined rank an alltoall fails before its splits are read.
    splits = [r["error_message"] for r in ours
              if r["error_message"].startswith("alltoall splits")]
    assert len(splits) == (0 if joined else 2)
    assert joined or ("must have one entry per rank" in splits[0]) != \
        ("must have one entry per rank" in splits[1])
    if joined:
        assert {"broadcast", "allgather", "alltoall"} <= errors
        assert kinds & {"BROADCAST", "ALLGATHER", "ALLTOALL"} == set()
        assert {r["last_joined_rank"] for r in ours
                if r["response_type"] in ("ALLREDUCE", "BARRIER")} \
            == {size - 1}
    else:
        assert {"BROADCAST", "ALLGATHER", "ALLTOALL", "BARRIER"} <= kinds
        assert any(len(r["tensor_names"]) > 1 for r in ours
                   if r["response_type"] == "ALLGATHER"), "nothing fused"


class _FakeControl:
    """Rank 0's side of the gather/broadcast: the workers' frames of each
    cycle in, rank 0's verdict out."""

    def __init__(self, cycles):
        self.cycles = iter(cycles)
        self.sent = []

    def gather(self, payload):
        assert payload == b""
        return [b""] + next(self.cycles)

    def broadcast(self, payload):
        self.sent.append(payload)
        return payload


class _FakeMesh:
    """The JAX star's mesh: ``recv(worker)`` yields that worker's frame of
    the cycle; ``send`` records."""

    def __init__(self, cycles):
        self.cycles = list(cycles)
        self.cycle = -1
        self.sent = []

    def recv(self, worker):
        if worker == 1:
            self.cycle += 1
        return self.cycles[self.cycle][worker - 1]

    def send(self, worker, payload):
        if worker == 1:
            self.sent.append(payload)


class _Replay:
    """A worker's side: its frame goes up, rank 0's verdict comes down."""

    def __init__(self, verdict):
        self.verdict = verdict

    def gather(self, payload):
        return None

    def broadcast(self, payload):
        assert payload is None
        return self.verdict


@pytest.mark.parametrize("cache", [0, 1024], ids=["cache0", "cache1024"])
@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("seed", range(2))
def test_rounds_with_a_late_join_broadcast_the_jax_frames(seed, size, cache):
    """Cycle 0: every rank but the last requests the tensors; cycle 1: the
    last rank's JOIN lands after their last requests and completes them
    (the collectives that move bits as ERRORs); cycle 2: the others request
    more allreduces and join, and the JOIN response goes out first.  The
    request frames and every cycle's verdict are the JAX package's bytes,
    and a worker decodes what rank 0 executes."""
    first = _request_sets(200 + seed, size, joined=False)
    more = [[dict(request_rank=r, request_type="ALLREDUCE",
                  tensor_name=f"late{i}", tensor_type="FLOAT32",
                  tensor_shape=[3 + i], device=0) for i in range(3)]
            for r in range(size)]
    join = [dict(request_rank=r, request_type="JOIN", tensor_name=JOIN)
            for r in range(size)]
    cycles = [[first[r] if r < size - 1 else [] for r in range(size)],
              [[] if r < size - 1 else [join[r]] for r in range(size)],
              [[join[r]] + more[r] if r < size - 1 else []
               for r in range(size)]]
    frames = []
    for c in range(3):
        frames.append([])
        for w in range(1, size):
            ours = messages.RequestList(
                [_request(messages, f) for f in cycles[c][w]]).to_bytes()
            theirs = jax_messages.RequestList(
                [_request(jax_messages, f) for f in cycles[c][w]]).to_bytes()
            assert ours == theirs, f"cycle {c} worker {w}"
            frames[-1].append(ours)
    ours_topo, jax_topo = _topologies(size)
    control = _FakeControl(frames)
    ours = controller.Controller(ours_topo, control,
                                 fusion_threshold_bytes=FUSION_BYTES,
                                 cache_capacity=cache)
    mesh = _FakeMesh(frames)
    theirs = jax_controller.Controller(jax_topo, mesh,
                                       fusion_threshold_bytes=FUSION_BYTES,
                                       cache_capacity=cache)
    lists = []
    for c in range(3):
        rl = ours.compute_response_list(
            [_request(messages, f) for f in cycles[c][0]])
        theirs.compute_response_list(
            [_request(jax_messages, f) for f in cycles[c][0]])
        assert control.sent[c] == mesh.sent[c], f"cycle {c}"
        worker = controller.Controller(
            ProcessTopology(rank=1, size=size, local_rank=1, local_size=size),
            _Replay(control.sent[c]), cache_capacity=cache)
        assert worker.compute_response_list([]) == rl
        lists.append(rl)
    assert lists[0].responses == []
    done = {n for r in lists[1].responses for n in r.tensor_names}
    assert done == {f["tensor_name"] for f in first[0]}
    assert lists[2].responses[0].response_type == messages.ResponseType.JOIN
    assert {n for r in lists[2].responses[1:] for n in r.tensor_names} \
        == {f"late{i}" for i in range(3)}


# ---------------------------------------------------------------------------
# the op chain's choice of plane
# ---------------------------------------------------------------------------


class _FakeGroup:
    """Stands in for the runtime's gloo or NCCL group: records which group
    each collective went to and moves nothing."""

    def __init__(self, name: str, calls: list):
        self.name, self.calls = name, calls

    def _call(self, *args):
        self.calls.append(self.name)
        return self

    allreduce = broadcast = allgather = alltoall_base = _call

    # A c10d Work's interface: the host plane waits in slices that an
    # elastic abort can interrupt (transport/control.py::wait).
    def wait(self, timeout=None):
        return True

    def is_completed(self):
        return True


def _chain_cases(size: int, devices):
    """One response and this rank's CPU entry per collective."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    kind = messages.DataType.FLOAT32
    rt = messages.ResponseType
    cases = [
        (rt.ALLREDUCE, [t.numel()], {}),
        (rt.BROADCAST, [t.numel()], {"root_rank": 0}),
        (rt.ALLGATHER, [2] * size, {}),
        (rt.ALLTOALL, ([2] + [0] * (size - 1)) * size,
         {"splits": [2] + [0] * (size - 1)}),
    ]
    for rtype, sizes, fields in cases:
        response = messages.Response(rtype, ["t"], kind, sizes,
                                     devices=list(devices))
        yield response, [TensorTableEntry("t", tensor=t.clone(), **fields)]


@pytest.mark.parametrize("size,plane,devices", [
    (1, PLANE_HOST, [-1]),
    *[(2, plane, devices) for plane in (PLANE_HOST, PLANE_NCCL)
      for devices in ([-1], [0], [-1, 0])]])
def test_op_chain_picks_the_plane_by_the_negotiated_devices(size, plane,
                                                            devices):
    """Size 1 runs the local op.  At size > 1 the device plane's op runs a
    response whose tensors are on the card on every rank, the host plane's
    one on the CPU on every rank, and a mix is refused on the device plane;
    the host plane takes all three."""
    calls = []
    manager = OperationManager()
    register_ops(manager, ProcessTopology(rank=0, size=size,
                                          local_size=size),
                 torch.device("cpu"), plane, _FakeGroup("gloo", calls),
                 _FakeGroup("nccl", calls))
    for response, entries in _chain_cases(size, devices):
        calls.clear()
        if plane == PLANE_NCCL and devices == [-1, 0]:
            with pytest.raises(HorovodInternalError,
                               match="Mismatched CPU/GPU device selection"):
                manager.execute(response, entries)
            assert calls == [], response.response_type
            continue
        assert manager.execute(response, entries).ok
        want = [] if size == 1 else \
            ["nccl"] if plane == PLANE_NCCL and devices == [0] else ["gloo"]
        assert calls == want, response.response_type
        assert entries[0].output is not None, response.response_type


# ---------------------------------------------------------------------------
# the np=1 API beside the JAX bridge
# ---------------------------------------------------------------------------

_NP1_DTYPES = ["bfloat16", "float16", "float32", "int32", "int64", "uint8"]


@pytest.fixture(scope="module")
def runtimes():
    jax_state.reset_global_state()
    jax_basics.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jax_state.reset_global_state()


def _payload(dtype: str, shape, seed: int = 0) -> np.ndarray:
    """Seeded values; bf16 as its uint16 bits (the top half of fp32s)."""
    rng = np.random.RandomState(seed)
    if dtype == "bfloat16":
        return (rng.randn(*shape).astype(np.float32).view(np.uint32)
                >> 16).astype(np.uint16)
    if dtype.startswith("float"):
        return (rng.randn(*shape) * 10).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(max(info.min, -2**30), min(info.max, 2**30),
                       shape).astype(dtype)


def _port_in(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_call(op: str, a: np.ndarray, dtype: str, *args, **kwargs):
    """The JAX bridge's op on the same values (its core's op for bf16)."""
    if dtype == "bfloat16":
        return getattr(jax_ops, op)(a.view(ml_dtypes.bfloat16), *args,
                                    **kwargs)
    return getattr(jax_torch, op)(torch.from_numpy(a.copy()), *args, **kwargs)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


@pytest.mark.parametrize("dtype", _NP1_DTYPES)
def test_np1_broadcast_matches_jax(runtimes, dtype):
    a = _payload(dtype, (4, 3), seed=1)
    ours = hvd.broadcast(_port_in(a, dtype), 0, name=f"np1.bcast.{dtype}")
    theirs = _jax_call("broadcast", a, dtype, 0, name=f"np1.bcast.{dtype}")
    assert ours.shape == (4, 3)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    t = _port_in(a, dtype)
    assert hvd.broadcast_(t, 0) is t
    np.testing.assert_array_equal(_bits(t), a)


@pytest.mark.parametrize("dtype", _NP1_DTYPES)
def test_np1_allgather_matches_jax(runtimes, dtype):
    a = _payload(dtype, (2, 5), seed=2)
    ours = hvd.allgather(_port_in(a, dtype), name=f"np1.gather.{dtype}")
    theirs = _jax_call("allgather", a, dtype, name=f"np1.gather.{dtype}")
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))
    scalar = hvd.allgather(torch.tensor(7, dtype=torch.int32))
    assert scalar.tolist() == [7]


@pytest.mark.parametrize("dtype", _NP1_DTYPES)
def test_np1_alltoall_matches_jax(runtimes, dtype):
    a = _payload(dtype, (3, 2), seed=3)
    ours = hvd.alltoall(_port_in(a, dtype), name=f"np1.a2a.{dtype}")
    theirs = _jax_call("alltoall", a, dtype, name=f"np1.a2a.{dtype}")
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def test_np1_objects_join_barrier_and_queries(runtimes):
    obj = {"step": 3, "lr": [0.1, 0.01]}
    assert hvd.broadcast_object(obj) == jax_torch.broadcast_object(obj)
    assert hvd.allgather_object(obj) == jax_torch.allgather_object(obj) \
        == [obj]
    assert hvd.join() == jax_torch.join() == 0
    assert hvd.barrier() is None and jax_torch.barrier() is None
    assert hvd.size_or_one() == jax_ops.size_or_one() == 1
    assert hvd.initialized() is jax_ops.initialized() is True


def test_np1_array_likes_like_the_jax_bridge(runtimes):
    """``examples/pytorch/pytorch_synthetic_benchmark.py:82-84``'s call."""
    values = np.array([1.5, 2.25], np.float64)
    ours = hvd.allreduce(values, op=hvd.Sum, name="np1.numpy").numpy()
    theirs = jax_torch.allreduce(values, op=jax_torch.Sum,
                                 name="np1.numpy").numpy()
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    got = hvd.broadcast([1, 2, 3], 0)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.tolist() == jax_torch.broadcast([1, 2, 3], 0).tolist()
    assert hvd.allgather(2.5).dtype == torch.float64


def test_np1_bad_alltoall_splits_error_like_jax(runtimes):
    a = np.arange(4, dtype=np.int32)
    with pytest.raises(HorovodInternalError) as ours:
        hvd.alltoall(torch.from_numpy(a), splits=[3], name="np1.bad")
    with pytest.raises(Exception) as theirs:
        jax_torch.alltoall(torch.from_numpy(a), splits=[3], name="np1.bad")
    assert str(ours.value) == str(theirs.value) == (
        "alltoall splits for np1.bad sum to 3 but first dimension is 4 on "
        "rank 0.")


def test_np1_optimizer_state_survives_its_own_broadcast(runtimes):
    """At np=1 the broadcasts give every tensor back unchanged, and AdamW's
    0-d CPU ``step`` goes through as a tensor."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(5, 4)).sum().backward()
    opt.step()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = {(pid, k): v.clone() for pid, s in opt.state_dict()["state"]
             .items() for k, v in s.items()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    after = opt.state_dict()["state"]
    for (pid, k), v in state.items():
        assert torch.equal(after[pid][k], v), (pid, k)
    assert after[0]["step"].dim() == 0


_EXPORTS = ["broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
            "allgather", "allgather_async", "alltoall", "join", "barrier",
            "broadcast_parameters", "broadcast_optimizer_state",
            "broadcast_object", "allgather_object"]


def _signature(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", _EXPORTS + ["size_or_one", "initialized"])
def test_exports_have_the_jax_bridges_signatures(name):
    theirs = getattr(jax_torch, name, None) or getattr(jax_ops, name)
    assert name in hvd.__all__
    assert _signature(getattr(hvd, name)) == _signature(theirs)


# ---------------------------------------------------------------------------
# jobs: the same body through both packages at np=3
# ---------------------------------------------------------------------------

_PORT_PRELUDE = '''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
PKG = "port"


def T(a, dt):
    if dt == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def call(op, x, *args, **kwargs):
    return getattr(hvd, op)(x, *args, **kwargs)
'''

_JAX_PRELUDE = '''
import ml_dtypes
import torch
torch.set_num_threads(1)
from horovod_tpu.frameworks.jax import ops as jax_ops
import horovod_tpu.torch as hvd
PKG = "jax"


def T(a, dt):
    if dt == "bfloat16":
        return a.view(ml_dtypes.bfloat16)
    return torch.from_numpy(a.copy())


def call(op, x, *args, **kwargs):
    # The bridge cannot hand bf16 back as a torch tensor: bf16 goes
    # through the bridge's core ops.
    mod = jax_ops if isinstance(x, np.ndarray) else hvd
    return getattr(mod, op)(x, *args, **kwargs)
'''

_BODY = '''
import hashlib, json
import torch.nn as nn

OUT = os.environ["COLLECTIVES_OUT"]
DTYPES = ("bfloat16", "float16", "float32", "int32", "int64", "uint8")
ROOT = size - 1
SPLITS = [[(r + 2 * k) % 4 for k in range(size)] for r in range(size)]


def payload(kind, i, r, rows, cols=3):
    rng = np.random.RandomState(1000 * kind + 10 * i + r)
    dt = DTYPES[i]
    if dt == "bfloat16":
        return (rng.randn(rows, cols).astype(np.float32).view(np.uint32)
                >> 16).astype(np.uint16)
    if dt.startswith("float"):
        return (rng.randn(rows, cols) * 10).astype(dt)
    info = np.iinfo(dt)
    return rng.randint(max(info.min, -2**30), min(info.max, 2**30),
                       (rows, cols)).astype(dt)


def N(x, dt):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if dt == "bfloat16" else x


out, info = {}, {}
for i, dt in enumerate(DTYPES):
    out["bcast." + dt] = N(call("broadcast", T(payload(1, i, rank, 4), dt),
                                ROOT, name="bcast." + dt), dt)
    out["gather." + dt] = N(call("allgather",
                                 T(payload(2, i, rank, rank + 1), dt),
                                 name="gather." + dt), dt)
    out["a2a." + dt] = N(call("alltoall",
                              T(payload(3, i, rank, sum(SPLITS[rank])), dt),
                              splits=SPLITS[rank], name="a2a." + dt), dt)

# In place, and two allgathers in flight at once (one fused response).
t = T(payload(4, 2, rank, 5), "float32")
hvd.broadcast_(t, 1, name="bcast_.float32")
out["bcast_.float32"] = N(t, "float32")
handles = [hvd.allgather_async(T(payload(5, 2, rank, 2 * rank + 1, k + 1),
                                 "float32"), name=f"fused.{k}")
           for k in range(2)]
for k, h in enumerate(handles):
    out[f"fused.{k}"] = N(hvd.synchronize(h), "float32")

info["bcast_obj"] = hvd.broadcast_object(
    {"rank": rank, "tag": "x" * rank, "lr": [0.1, rank]}, root_rank=1)
info["gather_obj"] = hvd.allgather_object(["y" * rank, rank])
out["numpy_sum"] = hvd.allreduce(
    np.array([rank, 0.25 * rank], np.float64), op=hvd.Sum,
    name="numpy.sum").numpy()


class Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(c)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(x + self.bn2(self.conv2(y)))


# A small ResNet from a per-rank seed, one local SGD-momentum step on the
# rank's own batch, then rank 0's weights, buffers and state everywhere.
torch.manual_seed(1234 + rank)
model = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1, bias=False),
                      nn.BatchNorm2d(8), nn.ReLU(), Block(8),
                      nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(8, 10))
opt = torch.optim.SGD(model.parameters(), lr=0.1 * (rank + 1), momentum=0.9)
rng = np.random.RandomState(50 + rank)
nn.functional.cross_entropy(
    model(torch.from_numpy(rng.rand(4, 3, 8, 8).astype(np.float32))),
    torch.from_numpy(rng.randint(0, 10, 4))).backward()
opt.step()


def digests():
    sha = lambda t: hashlib.sha256(
        t.detach().contiguous().numpy().tobytes()).hexdigest()
    st = opt.state_dict()
    return ({k: sha(v) for k, v in model.state_dict().items()},
            {f"{pid}.{k}": sha(v) for pid, s in st["state"].items()
             for k, v in s.items()},
            st["param_groups"])


info["before"] = digests()
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
hvd.broadcast_optimizer_state(opt, root_rank=0)
info["after"] = digests()
info["buffer_dtypes"] = sorted({str(v.dtype) for v in
                                model.state_dict().values()})

# Rank 0 joins at once; the others allreduce, then join.
if rank == 0:
    info["join"] = hvd.join()
else:
    for k in range(2):
        out[f"joined.{k}"] = N(hvd.allreduce(
            T(payload(6, 2, rank, 5, k + 2), "float32"), op=hvd.Sum,
            name=f"joined.{k}"), "float32")
    out["joined.int"] = N(hvd.allreduce(
        T(payload(6, 3, rank, 4), "int32"), op=hvd.Sum, name="joined.int"),
        "int32")
    info["join"] = hvd.join()
hvd.barrier()
info["barrier"] = True
np.savez(f"{OUT}/{PKG}.rank{rank}.npz", **out)
with open(f"{OUT}/{PKG}.rank{rank}.json", "w") as f:
    json.dump(info, f)
'''

_BODY_DTYPES = ("bfloat16", "float16", "float32", "int32", "int64", "uint8")
SIZE = 3


def _load(out: Path, pkg: str):
    return [(dict(np.load(out / f"{pkg}.rank{r}.npz")),
             json.loads((out / f"{pkg}.rank{r}.json").read_text()))
            for r in range(SIZE)]


@pytest.fixture(scope="module")
def port_np3(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_port")
    script = out / "worker.py"
    script.write_text(_PORT_PRELUDE + _BODY + '''
hvd.shutdown()
print("WORKER_DONE", rank)
''')
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT=GLOO_TIMEOUT,
               COLLECTIVES_OUT=str(out))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "-np", str(SIZE), "--verbose", sys.executable, str(script)],
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
def jax_np3(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_jax")
    run_distributed(SIZE, _JAX_PRELUDE + _BODY, timeout=45, retries=1,
                    extra_env={"HOROVOD_MESH_STARTUP_TIMEOUT": GLOO_TIMEOUT,
                               "COLLECTIVES_OUT": str(out)})
    return _load(out, "jax")


def _payload_job(kind: int, i: int, r: int, rows: int, cols: int = 3):
    """``payload`` of ``_BODY``: the inputs each rank sent."""
    rng = np.random.RandomState(1000 * kind + 10 * i + r)
    dt = _BODY_DTYPES[i]
    if dt == "bfloat16":
        return (rng.randn(rows, cols).astype(np.float32).view(np.uint32)
                >> 16).astype(np.uint16)
    if dt.startswith("float"):
        return (rng.randn(rows, cols) * 10).astype(dt)
    info = np.iinfo(dt)
    return rng.randint(max(info.min, -2**30), min(info.max, 2**30),
                       (rows, cols)).astype(dt)


_SPLITS = [[(r + 2 * k) % 4 for k in range(SIZE)] for r in range(SIZE)]


def _same_bits(port_np3, jax_np3, key):
    for r, ((ours, _), (theirs, _)) in enumerate(zip(port_np3, jax_np3)):
        assert ours[key].dtype == theirs[key].dtype, (r, key)
        assert ours[key].shape == theirs[key].shape, (r, key)
        assert ours[key].tobytes() == theirs[key].tobytes(), (r, key)


@pytest.mark.parametrize("i,dtype", list(enumerate(_BODY_DTYPES)))
def test_broadcast_from_a_nonzero_root_bit_exact(port_np3, jax_np3, i, dtype):
    root = _payload_job(1, i, SIZE - 1, 4)
    for arrays, _ in port_np3:
        assert arrays["bcast." + dtype].tobytes() == root.tobytes()
    _same_bits(port_np3, jax_np3, "bcast." + dtype)


@pytest.mark.parametrize("i,dtype", list(enumerate(_BODY_DTYPES)))
def test_ragged_allgather_bit_exact(port_np3, jax_np3, i, dtype):
    expected = np.concatenate([_payload_job(2, i, r, r + 1)
                               for r in range(SIZE)])
    for arrays, _ in port_np3:
        got = arrays["gather." + dtype]
        assert got.shape == expected.shape == (6, 3)
        assert got.tobytes() == expected.tobytes()
    _same_bits(port_np3, jax_np3, "gather." + dtype)


@pytest.mark.parametrize("i,dtype", list(enumerate(_BODY_DTYPES)))
def test_uneven_alltoall_bit_exact(port_np3, jax_np3, i, dtype):
    sent = [_payload_job(3, i, r, sum(_SPLITS[r])) for r in range(SIZE)]
    for k, (arrays, _) in enumerate(port_np3):
        parts = []
        for r in range(SIZE):
            lo = sum(_SPLITS[r][:k])
            parts.append(sent[r][lo:lo + _SPLITS[r][k]])
        expected = np.concatenate(parts)
        assert arrays["a2a." + dtype].tobytes() == expected.tobytes()
        assert arrays["a2a." + dtype].shape == expected.shape
    _same_bits(port_np3, jax_np3, "a2a." + dtype)


def test_inplace_broadcast_and_fused_allgathers_bit_exact(port_np3, jax_np3):
    root = _payload_job(4, 2, 1, 5)
    for arrays, _ in port_np3:
        assert arrays["bcast_.float32"].tobytes() == root.tobytes()
        for k in range(2):
            expected = np.concatenate([_payload_job(5, 2, r, 2 * r + 1, k + 1)
                                       for r in range(SIZE)])
            np.testing.assert_array_equal(arrays[f"fused.{k}"], expected)
    for key in ("bcast_.float32", "fused.0", "fused.1"):
        _same_bits(port_np3, jax_np3, key)


def test_object_collectives_equal_the_jax_jobs(port_np3, jax_np3):
    for (_, ours), (_, theirs) in zip(port_np3, jax_np3):
        assert ours["bcast_obj"] == theirs["bcast_obj"] == \
            {"rank": 1, "tag": "x", "lr": [0.1, 1]}
        assert ours["gather_obj"] == theirs["gather_obj"] == \
            [["y" * r, r] for r in range(SIZE)]


def test_numpy_allreduce_gives_a_cpu_tensor(port_np3, jax_np3):
    """``examples/pytorch/pytorch_synthetic_benchmark.py:82-84``'s call."""
    expected = np.array([3.0, 0.75])
    for (ours, _), (theirs, _) in zip(port_np3, jax_np3):
        assert ours["numpy_sum"].dtype == np.float64
        np.testing.assert_array_equal(ours["numpy_sum"], expected)
    _same_bits(port_np3, jax_np3, "numpy_sum")


@pytest.mark.parametrize("what", ["params", "optimizer state",
                                  "param_groups"])
def test_broadcast_parameters_and_optimizer_state(port_np3, jax_np3, what):
    """Every rank ends with rank 0's weights, buffers (int64
    ``num_batches_tracked`` included), momentum and hyperparameters; they
    differed before, and the JAX job ends with the same."""
    k = ["params", "optimizer state", "param_groups"].index(what)
    root = port_np3[0][1]["before"][k]
    assert any(info["before"][k] != root for _, info in port_np3[1:])
    for (_, ours), (_, theirs) in zip(port_np3, jax_np3):
        assert ours["after"][k] == root
        assert theirs["after"][k] == ours["after"][k]
    assert "torch.int64" in port_np3[0][1]["buffer_dtypes"]


@pytest.mark.parametrize("key", ["joined.0", "joined.1", "joined.int"])
def test_allreduce_with_a_joined_rank_equals_the_jax_job(port_np3, jax_np3,
                                                         key):
    """Rank 0 joined first: the others' sum, with its zeros, on every rank
    that asked."""
    kind, i, rows, cols = {"joined.0": (6, 2, 5, 2), "joined.1": (6, 2, 5, 3),
                           "joined.int": (6, 3, 4, 3)}[key]
    addends = [_payload_job(kind, i, r, rows, cols) for r in range(1, SIZE)]
    expected = sum(a.astype(np.float64) for a in addends)
    for r, (arrays, info) in enumerate(port_np3):
        assert info["join"] == 0 and info["barrier"] is True
        if r == 0:
            assert key not in arrays
            continue
        np.testing.assert_allclose(arrays[key], expected, rtol=2 ** -23)
        assert arrays[key].tobytes() == jax_np3[r][0][key].tobytes()
