"""The port's cross-rank negotiation and allreduce against the JAX package.

In one process: seeded multi-rank request sets, with mismatched dtypes,
operations, scale factors and shapes, go through both controllers'
``_increment`` → ``_construct_response`` → ``_fuse_responses`` (both
controllers' caches off) and through whole coordinator rounds over fake
transports (both with the response cache off and on): the responses must
be equal field by field and the broadcast frames byte for byte.

Across processes: three jobs, each run once per module and read by many
tests.  Two go through the port's launcher on the CPU (gloo, the host
plane) at np=2 and np=3; one is the JAX package's np=2 job on the same
int32 and fp32 payloads, through ``tests/helpers.run_distributed``.  Every
job has a 60 s limit and gloo timeouts of 60 s, so a hang fails fast.

Tolerances against a float64 numpy sum of the same inputs: int32 exact;
fp32 within ``size · 2^-24 · Σ|x|`` (each of the size-1 additions rounds
once); bf16 crosses the host plane's narrow ring, which adds in fp32 and
rounds once per hop: at np=2 within one bf16 rounding (``2^-8 · |sum|``)
plus the fp32 bound, and at any size each element exactly the ring's sum
in the order of its chunk's first sender.  Applied gradients against the
float64 mean of the ranks' local gradients: rtol 1e-5 (an fp32 sum and a
scale).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import controller as jax_controller
from horovod_tpu.core import messages as jax_messages
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller, messages

from .helpers import run_distributed
from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
GLOO_TIMEOUT = "60"
#: Small enough that a cycle's tensors fill more than one bucket.
FUSION_BYTES = 2048

# ---------------------------------------------------------------------------
# negotiation in one process
# ---------------------------------------------------------------------------

_DTYPES = ["FLOAT32", "FLOAT16", "BFLOAT16", "INT32"]
_MISMATCHES = ["dtype", "op", "scale", "shape"]


def _request_sets(seed: int, size: int):
    """Per rank, the same 16 tensors in a rank-specific order; four of
    them disagree on one rank (not rank 0) in dtype, operation, scale or
    shape."""
    rng = np.random.RandomState(seed)
    spec = {}
    for i in range(16):
        spec[f"t{i}"] = dict(
            request_type="ADASUM" if rng.rand() < 0.2 else "ALLREDUCE",
            tensor_type=_DTYPES[rng.choice(4, p=[0.4, 0.3, 0.2, 0.1])],
            tensor_shape=[int(d) for d in rng.randint(1, 20,
                                                      rng.randint(1, 3))],
            device=int(rng.choice([-1, 0], p=[0.2, 0.8])),
            prescale_factor=float(rng.choice([1.0, 0.5], p=[0.8, 0.2])),
            postscale_factor=float(rng.choice([1.0, 1.0 / size],
                                              p=[0.8, 0.2])))
    bad = dict(zip(rng.choice(list(spec), 4, replace=False), _MISMATCHES))
    per_rank = []
    for rank in range(size):
        reqs = []
        for name in rng.permutation(list(spec)):
            fields = dict(spec[name], request_rank=rank,
                          tensor_name=str(name))
            if rank == 1 + seed % (size - 1) and name in bad:
                kind = bad[name]
                if kind == "dtype":
                    fields["tensor_type"] = "INT64"
                elif kind == "op":
                    fields["request_type"] = "BROADCAST"
                elif kind == "scale":
                    fields["prescale_factor"] = 3.0
                else:
                    fields["tensor_shape"] = fields["tensor_shape"] + [2]
            if rng.rand() < 0.1:
                fields["device"] = -1 - fields["device"]
            reqs.append(fields)
        per_rank.append(reqs)
    return per_rank


def _request(mod, fields: dict):
    return mod.Request(**{
        **fields, "request_type": mod.RequestType[fields["request_type"]],
        "tensor_type": mod.DataType[fields["tensor_type"]]})


def _fields(resp) -> dict:
    return {f.name: getattr(resp, f.name)
            for f in dataclasses.fields(messages.Response)} | {
        "response_type": resp.response_type.name,
        "tensor_type": resp.tensor_type.name}


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


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_responses_match_jax_controller(seed, size):
    ours_topo, jax_topo = _topologies(size)
    per_rank = _request_sets(seed, size)
    ours = _drive(controller.Controller(ours_topo, _Unused(),
                                        fusion_threshold_bytes=FUSION_BYTES,
                                        cache_capacity=0),
                  messages, per_rank)
    theirs = _drive(jax_controller.Controller(
        jax_topo, None, fusion_threshold_bytes=FUSION_BYTES, cache_capacity=0),
        jax_messages, per_rank)
    assert ours == theirs
    errors = [r["error_message"] for r in ours
              if r["response_type"] == "ERROR"]
    assert len(errors) == 4
    assert {e.split(" for ")[0] for e in errors} >= {
        "Mismatched data types", "Mismatched operations",
        "Mismatched pre/postscale factors"}
    assert any(len(r["tensor_names"]) > 1 for r in ours), "nothing fused"


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


@pytest.mark.parametrize("cache", [0, 1024], ids=["cache0", "cache1024"])
@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_coordinator_rounds_broadcast_the_jax_frames(seed, size, cache):
    """Three cycles in which the ranks' requests arrive at different times:
    the same verdict bytes every cycle (oldest tensors first, so the
    readiness order is exercised; with the cache on, the bit assignments
    too), a worker's shutdown in the last cycle reaches the verdict, and a
    worker decodes what rank 0 executes."""
    per_rank = _request_sets(100 + seed, size)
    rng = np.random.RandomState(seed)
    cuts = [sorted(rng.randint(0, 17, 2)) for _ in range(size)]
    split = [[reqs[:a], reqs[a:b], reqs[b:]]
             for reqs, (a, b) in zip(per_rank, cuts)]
    frames = [[messages.RequestList(
        [_request(messages, f) for f in split[w][c]],
        shutdown=(c == 2 and w == size - 1)).to_bytes()
        for w in range(1, size)] for c in range(3)]
    ours_topo, jax_topo = _topologies(size)
    control = _FakeControl(frames)
    ours = controller.Controller(ours_topo, control,
                                 fusion_threshold_bytes=FUSION_BYTES,
                                 cache_capacity=cache)
    mesh = _FakeMesh(frames)
    theirs = jax_controller.Controller(jax_topo, mesh,
                                       fusion_threshold_bytes=FUSION_BYTES,
                                       cache_capacity=cache)
    for c in range(3):
        rl = ours.compute_response_list(
            [_request(messages, f) for f in split[0][c]])
        theirs.compute_response_list(
            [_request(jax_messages, f) for f in split[0][c]])
        assert control.sent[c] == mesh.sent[c], f"cycle {c}"
        assert rl.shutdown == (c == 2)
        assert bool(rl.cache_assignments) == (cache > 0 and any(
            r.response_type != messages.ResponseType.ERROR
            for r in rl.responses))
        worker = controller.Controller(
            ProcessTopology(rank=1, size=size, local_rank=1, local_size=size),
            _Replay(control.sent[c]), cache_capacity=cache)
        assert worker.compute_response_list([]) == rl
    assert sum(len(r.responses) for r in map(
        messages.ResponseList.from_bytes, control.sent)) > 0


class _Replay:
    """A worker's side: its frame goes up, rank 0's verdict comes down."""

    def __init__(self, verdict):
        self.verdict = verdict

    def gather(self, payload):
        # An idle worker's frame: an empty mask with the cache on, an empty
        # list with it off.
        if messages.is_mask_frame(payload):
            assert messages.MaskFrame.from_bytes(payload).mask == b""
        else:
            assert messages.RequestList.from_bytes(payload).requests == []
        return None

    def broadcast(self, payload):
        assert payload is None
        return self.verdict


def test_a_controller_of_several_ranks_needs_a_control_plane():
    with pytest.raises(HorovodInternalError, match="control plane"):
        controller.Controller(ProcessTopology(rank=0, size=2, local_size=2))


@pytest.mark.parametrize("plane,device,match", [
    ("nccl", "cpu", "nccl needs the runtime on a card"),
    ("auto", "cpu", "expected 'cpu'.*or 'nccl'"),
    ("xla", "cpu", "expected 'cpu'.*or 'nccl'"),
])
def test_unmet_or_unknown_plane_raises_at_init(monkeypatch, plane, device,
                                               match):
    """No plane is chosen quietly: an unknown value or an unmet request
    raises before anything connects."""
    hvd.shutdown()
    for key, value in (("HOROVOD_SIZE", "2"), ("HOROVOD_RANK", "0"),
                       ("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1"),
                       ("HOROVOD_GLOO_RENDEZVOUS_PORT", "1"),
                       ("HOROVOD_DATA_PLANE", plane)):
        monkeypatch.setenv(key, value)
    with pytest.raises(HorovodInternalError, match=match):
        hvd.init(device=device)
    assert not hvd.is_initialized()


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

# The payloads of both packages' jobs: name -> this rank's numpy values.
PAYLOADS = '''
import numpy as np

def payloads(rank):
    out = {}
    for i, n in enumerate((1, 37, 1000)):
        rng = np.random.RandomState(100 * rank + i)
        out[f"i32.{i}"] = rng.randint(-2**20, 2**20, n).astype(np.int32)
        out[f"f32.{i}"] = (rng.randn(n) * 10).astype(np.float32)
        out[f"bf16.{i}"] = (rng.randn(n) * 10).astype(np.float32)
    return out
'''
exec(PAYLOADS)

_PORT_WORKER = PAYLOADS + '''
import hashlib, json, os, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import cross_entropy_loss, train_step
from horovod_tpu_torch.transport.store import Store

# The user's own default process group (one rank in each process): the
# runtime neither refuses it nor tears it down.
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
arrays, info = {}, {"size": size}

# Every payload in flight at once: the cycle fuses them by dtype.
handles = {}
for name, values in payloads(rank).items():
    t = torch.from_numpy(values.copy())
    if name.startswith("bf16"):
        t = t.to(torch.bfloat16)
    arrays["in." + name] = t.float().numpy() if name.startswith("bf16") \\
        else values
    handles[name] = hvd.allreduce_async(t, op=hvd.Sum, name="sum." + name)
for name, h in handles.items():
    out = hvd.synchronize(h)
    arrays["sum." + name] = out.float().numpy() if name.startswith("bf16") \\
        else out.numpy()

arrays["avg"] = hvd.allreduce(torch.from_numpy(payloads(rank)["f32.2"]),
                              op=hvd.Average, name="avg").numpy()

# The same eight tensors, enqueued in a different order on every rank.
order = np.random.RandomState(rank + 7).permutation(8)
handles = [(int(i), hvd.allreduce_async(
    torch.full((5,), float(i * (rank + 1))), op=hvd.Sum, name=f"order.{i}"))
    for i in order]
info["order"] = [int(i) for i in order]
info["order_sums"] = {i: hvd.synchronize(h).tolist() for i, h in handles}

# DistributedOptimizer whose hooks fire in a different order on each rank:
# one backward per parameter, in a rank-specific order.
ps = [torch.nn.Parameter(torch.zeros(3)) for _ in range(6)]
hook_opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=1.0),
                                    named_parameters=[(f"p{i}", p)
                                                      for i, p in enumerate(ps)])
info["hook_order"] = [int(i) for i in
                      np.random.RandomState(rank + 11).permutation(6)]
for i in info["hook_order"]:
    (ps[i] * float((i + 1) * (rank + 1))).sum().backward()
hook_opt.step()
info["hook_grads"] = [p.grad.tolist() for p in ps]

# The coordinator names the first request it took: rank 0's goes out
# first, and the others enqueue once its background loop has taken it
# (within a cycle the coordinator reads the ranks in order).
store = Store.connect(os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
                      int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]), 60)
if rank != 0:
    store.wait("mismatch", ["taken"], 60)
mismatch = hvd.allreduce_async(
    torch.ones(3, dtype=torch.int32 if rank == size - 1 else torch.float32),
    name="mismatch")
if rank == 0:
    while global_state().tensor_queue._pending:
        time.sleep(0.001)
    store.set("mismatch", "taken", b"1")
try:
    hvd.synchronize(mismatch)
    info["mismatch"] = ""
except HorovodInternalError as e:
    info["mismatch"] = str(e)

model = resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                      block_cls=resnet.BottleneckBlock, num_classes=10,
                      num_filters=8, dtype=torch.float32,
                      fuse_conv1x1_bn=True,
                      generator=torch.Generator().manual_seed(0))
params = list(model.named_parameters())
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
    named_parameters=params)
rng = np.random.RandomState(5)
x_all = torch.from_numpy(rng.rand(2 * size, 32, 32, 3).astype(np.float32))
y_all = torch.from_numpy(rng.randint(0, 10, 2 * size))
xs, ys = x_all[2 * rank:2 * rank + 2], y_all[2 * rank:2 * rank + 2]
info["hashes"] = []
for step in range(2):
    model.train()
    local = torch.autograd.grad(cross_entropy_loss(model(xs), ys),
                                [p for _, p in params])
    before = cuda_backend.stats["allreduce_tensors"]
    train_step(model, opt, {"x": xs, "y": ys})
    info[f"reduced.{step}"] = cuda_backend.stats["allreduce_tensors"] - before
    for (name, p), g in zip(params, local):
        arrays[f"local.{step}.{name}"] = g.numpy()
        arrays[f"applied.{step}.{name}"] = p.grad.numpy().copy()
    info["hashes"].append(hashlib.sha256(b"".join(
        p.detach().numpy().tobytes() for _, p in params)).hexdigest())
info["n_params"] = len(params)

if rank == size - 1:
    hvd.shutdown()
else:
    info["stopped_by_peer"] = global_state().shutdown_complete.wait(30)
    try:
        hvd.allreduce(torch.ones(1), name="after")
        info["after_shutdown"] = ""
    except HorovodInternalError as e:
        info["after_shutdown"] = str(e)
    hvd.shutdown()
probe = torch.full((1,), 3.0)
dist.all_reduce(probe)
info["user_group_after_shutdown"] = [dist.is_initialized(), probe.item()]
dist.destroy_process_group()
np.savez(f"{sys.argv[1]}/rank{rank}.npz", **arrays)
with open(f"{sys.argv[1]}/rank{rank}.json", "w") as f:
    json.dump(info, f)
print("WORKER_DONE", rank)
'''


def _run_port_job(size: int, out: Path):
    script = out / "worker.py"
    script.write_text(_PORT_WORKER)
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT=GLOO_TIMEOUT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "-np", str(size), sys.executable, str(script), str(out)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np={size} job timed out after {JOB_TIMEOUT}s\n"
                    f"{stdout}\n{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    for r in range(size):
        assert f"[{r}]<stdout>: WORKER_DONE {r}" in stdout, stdout
    return [(dict(np.load(out / f"rank{r}.npz")),
             json.loads((out / f"rank{r}.json").read_text()))
            for r in range(size)]


_jobs = {}


def _port_job(size: int, tmp_path_factory):
    if size not in _jobs:
        _jobs[size] = _run_port_job(size,
                                    tmp_path_factory.mktemp(f"np{size}"))
    return _jobs[size]


@pytest.fixture(scope="module", params=[2, 3], ids=["np2", "np3"])
def job(request, tmp_path_factory):
    return _port_job(request.param, tmp_path_factory)


def _names(prefix: str):
    return [n for n in payloads(0) if n.startswith(prefix)]


def _float64_sum(job, name):
    return sum(arrays["in." + name].astype(np.float64) for arrays, _ in job)


def test_every_rank_joined_a_job_of_its_size(job):
    assert [info["size"] for _, info in job] == [len(job)] * len(job)


@pytest.mark.parametrize("name", _names("i32"))
def test_int32_sum_is_exact(job, name):
    expected = sum(payloads(r)[name].astype(np.int64)
                   for r in range(len(job)))
    for arrays, _ in job:
        assert arrays["sum." + name].dtype == np.int32
        np.testing.assert_array_equal(arrays["sum." + name], expected)


@pytest.mark.parametrize("name", _names("f32"))
def test_fp32_sum_within_fp32_rounding(job, name):
    exact = _float64_sum(job, name)
    bound = len(job) * 2.0 ** -24 * sum(
        np.abs(arrays["in." + name]) for arrays, _ in job)
    for arrays, _ in job:
        assert np.all(np.abs(arrays["sum." + name] - exact) <= bound)


def _ring_sum(values, start: int) -> np.ndarray:
    """The narrow ring's sum of bf16 ``values`` (one array per rank) for a
    chunk that rank ``start`` sends first: each later rank adds its value
    in fp32 and rounds back to bf16."""
    size = len(values)
    acc = values[start].astype(ml_dtypes.bfloat16)
    for k in range(1, size):
        acc = (acc.astype(np.float32) + values[(start + k) % size]).astype(
            ml_dtypes.bfloat16)
    return acc.astype(np.float32)


@pytest.mark.parametrize("name", _names("bf16"))
def test_bf16_sum_widened_and_rounded_once(job, name):
    """Widened in each add and rounded once per hop: once at np=2 (fault
    C3), and at np=3 every element is the ring's sum in the order of one of
    the ranks, the same on every rank."""
    exact = _float64_sum(job, name)
    bound = 2.0 ** -8 * np.abs(exact) + len(job) * 2.0 ** -24 * sum(
        np.abs(arrays["in." + name]) for arrays, _ in job)
    values = [arrays["in." + name] for arrays, _ in job]
    orders = np.stack([_ring_sum(values, r) for r in range(len(job))])
    first = job[0][0]["sum." + name]
    for arrays, _ in job:
        got = arrays["sum." + name]
        assert got.tobytes() == first.tobytes()
        assert np.all((orders == got[None, :]).any(axis=0))
        if len(job) == 2:
            assert np.all(np.abs(got - exact) <= bound)
        # The result is a bf16 value.
        assert np.array_equal(got, got.astype(ml_dtypes.bfloat16)
                              .astype(np.float32))


def test_average_is_the_sum_over_size(job):
    exact = sum(payloads(r)["f32.2"].astype(np.float64)
                for r in range(len(job))) / len(job)
    for arrays, _ in job:
        np.testing.assert_allclose(arrays["avg"], exact, rtol=1e-5,
                                   atol=1e-5)


def test_tensors_enqueued_in_different_orders_all_complete(job):
    orders = [info["order"] for _, info in job]
    assert len({tuple(o) for o in orders}) == len(job)
    for _, info in job:
        for i in range(8):
            want = float(i * sum(r + 1 for r in range(len(job))))
            assert info["order_sums"][str(i)] == [want] * 5


def test_optimizer_hooks_firing_in_different_orders(job):
    """Each rank's gradient hooks fire in its own order; negotiation pairs
    them, and every rank applies the mean."""
    size = len(job)
    assert len({tuple(info["hook_order"]) for _, info in job}) == size
    mean_rank_factor = sum(r + 1 for r in range(size)) / size
    for _, info in job:
        for i, grad in enumerate(info["hook_grads"]):
            np.testing.assert_allclose(grad, [(i + 1) * mean_rank_factor] * 3,
                                       rtol=1e-6)


def test_mismatched_dtype_errors_on_every_rank(job):
    size = len(job)
    want = (f"Mismatched data types for mismatch: rank 0 sent FLOAT32, "
            f"rank {size - 1} sent INT32.")
    assert [info["mismatch"] for _, info in job] == [want] * size


def test_users_default_process_group_survives_the_runtime(job):
    """The runtime's groups are its own: a default group the user set up
    before ``hvd.init()`` still works after ``hvd.shutdown()``."""
    for _, info in job:
        assert info["user_group_after_shutdown"] == [True, 3.0]


@pytest.mark.parametrize("step", [0, 1])
def test_resnet_parameters_identical_across_ranks(job, step):
    hashes = {info["hashes"][step] for _, info in job}
    assert len(hashes) == 1


@pytest.mark.parametrize("step", [0, 1])
def test_resnet_every_gradient_allreduced(job, step):
    for _, info in job:
        assert info[f"reduced.{step}"] == info["n_params"] > 0


@pytest.mark.parametrize("step", [0, 1])
def test_resnet_applied_gradient_is_the_mean_of_local_ones(job, step):
    keys = [k[len(f"local.{step}."):] for k in job[0][0]
            if k.startswith(f"local.{step}.")]
    assert len(keys) == job[0][1]["n_params"]
    for key in keys:
        mean = sum(arrays[f"local.{step}.{key}"].astype(np.float64)
                   for arrays, _ in job) / len(job)
        scale = np.abs(mean).max() + 1e-12
        for arrays, _ in job:
            np.testing.assert_allclose(arrays[f"applied.{step}.{key}"],
                                       mean, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=key)
        # The ranks' shards differ, so the mean is not any rank's own.
        if np.abs(mean).max() > 0:
            assert not np.array_equal(job[0][0][f"local.{step}.{key}"],
                                      job[-1][0][f"local.{step}.{key}"])


def test_one_rank_shutting_down_stops_every_rank(job):
    for _, info in job[:-1]:
        assert info["stopped_by_peer"] is True
        assert "not running" in info["after_shutdown"]


# ---------------------------------------------------------------------------
# the JAX package's np=2 job on the same payloads
# ---------------------------------------------------------------------------

_JAX_BODY = PAYLOADS + '''
handles = {name: hvd.allreduce_async(values, op=hvd.Sum, name="sum." + name)
           for name, values in payloads(rank).items()
           if not name.startswith("bf16")}
for name, h in handles.items():
    out = np.asarray(hvd.synchronize(h))
    print("RESULT", name, out.dtype.str, out.tobytes().hex())
'''


@pytest.fixture(scope="module")
def jax_np2():
    outs = run_distributed(2, _JAX_BODY, timeout=45, retries=1,
                           extra_env={"HOROVOD_MESH_STARTUP_TIMEOUT":
                                      GLOO_TIMEOUT})
    results = []
    for out in outs:
        got = {}
        for line in out.splitlines():
            if line.startswith("RESULT "):
                _, name, dtype, data = line.split()
                got[name] = np.frombuffer(bytes.fromhex(data), dtype=dtype)
        results.append(got)
    return results


@pytest.mark.parametrize("name", _names("i32"))
def test_int32_sums_bit_exact_against_the_jax_job(jax_np2, tmp_path_factory,
                                                  name):
    ours = _port_job(2, tmp_path_factory)
    for (arrays, _), theirs in zip(ours, jax_np2):
        assert arrays["sum." + name].tobytes() == theirs[name].tobytes()


@pytest.mark.parametrize("name", _names("f32"))
def test_fp32_sums_against_the_jax_job(jax_np2, tmp_path_factory, name):
    """Two fp32 addends round once in either order: equal bits."""
    ours = _port_job(2, tmp_path_factory)
    for (arrays, _), theirs in zip(ours, jax_np2):
        assert theirs[name].dtype == np.float32
        np.testing.assert_array_equal(arrays["sum." + name], theirs[name])

