"""The host plane's narrow ring against the JAX package's ``RingAllreduce``.

A bf16 or fp16 response on the host plane keeps its dtype on the wire
(``backend/cuda.py``): fused narrow, prescaled, reduced by a ring over the
gloo group's send/recv whose every hop adds in fp32 and rounds back once,
then postscaled.  The JAX host ring does the same
(``horovod_tpu/backend/cpu_ring.py``, ``RingAllreduce.execute``).

In one process, the P ranks as threads: the port's ``Allreduce`` op on gloo
groups over one in-process ``HashStore``, the JAX one over a fake mesh
that implements the three calls its ring makes (``send``,
``recv_into_async``, ``deferred_digests_for``).  At P = 2, 3 and 4, for
bf16 and fp16 with a prescale and a postscale, every rank's outputs must
be the JAX ring's bits; the bytes handed to the group must be the narrow
ones, two bytes per element per hop; fp32 must still take gloo's
allreduce, bit for bit, and send nothing through the ring.

Across processes, one module-scoped np=3 job of 60 s at most through the
port's launcher: ``hvd.allreduce`` of a bf16 Sum, an fp16 Average with a
prescale and an fp32 tensor under ``Compression.fp16``, each against the
JAX ring on the same three inputs, bit for bit, with each rank's ring bytes.
"""

from __future__ import annotations

import collections
import json
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

from horovod_tpu.backend import cpu_ring as jax_cpu_ring
from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import messages as jax_messages
from horovod_tpu.core import tensor_queue as jax_tensor_queue
from horovod_tpu_torch.backend import cuda as cuda_backend
from horovod_tpu_torch.common.env import PLANE_HOST
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core.messages import DataType, Response, ResponseType
from horovod_tpu_torch.core.tensor_queue import TensorTableEntry
from horovod_tpu_torch.transport.control import gloo_group

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
THREAD_TIMEOUT = 60
JOB_TIMEOUT = 60

_NP = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
       "float32": np.float32}
_TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
# Entry sizes: an odd total, so the chunks differ in length at P = 2 and 4.
_SIZES = [17, 1, 40, 9]


def _to_torch(x: np.ndarray) -> torch.Tensor:
    """A numpy bf16/fp16/fp32 array as a torch tensor of the same bits."""
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _inputs(size: int, dtype: str, sizes=_SIZES, seed: int = 0):
    """Per rank, seeded values spanning a few binades, in ``dtype``."""
    out = []
    for r in range(size):
        rng = np.random.RandomState(seed + 31 * r)
        out.append([(rng.randn(n) * 10.0 ** rng.uniform(-1, 1, n))
                    .astype(np.float32).astype(_NP[dtype]) for n in sizes])
    return out


def _threads(size: int, fn):
    """``fn(rank)`` on ``size`` threads; the results in rank order."""
    results, errors = [None] * size, []

    def run(rank):
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True,
                                name=f"ring-rank{r}") for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(THREAD_TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a rank never finished"
    if errors:
        raise errors[0]
    return results


def _port_ring(size: int, inputs, dtype: str, pre: float, post: float,
               gloo_reference: bool = False):
    """Every rank's outputs of the port's host-plane ``Allreduce`` (and,
    with ``gloo_reference``, gloo's allreduce of the same fused, prescaled
    buffer, postscaled: what the plane did before the narrow ring), with
    the ring bytes all ranks handed to the group."""
    store = dist.HashStore()
    groups = [None] * size
    before = cuda_backend.stats["host_ring_bytes_sent"]

    def rank_fn(rank):
        groups[rank] = gloo_group(dist.PrefixStore("ring", store), rank,
                                  size, THREAD_TIMEOUT)
        op = cuda_backend.Allreduce(
            ProcessTopology(rank=rank, size=size, local_size=size),
            torch.device("cpu"), PLANE_HOST, groups[rank])
        entries = [TensorTableEntry(f"t{i}", tensor=_to_torch(x))
                   for i, x in enumerate(inputs[rank])]
        response = Response(
            ResponseType.ALLREDUCE, [e.tensor_name for e in entries],
            DataType.from_torch(_TORCH[dtype]),
            [e.tensor.numel() for e in entries], devices=[-1],
            prescale_factor=pre, postscale_factor=post)
        assert op.execute(response, entries).ok
        outs = [_to_numpy(e.output) for e in entries]
        if not gloo_reference:
            return outs
        fused = torch.cat([e.tensor.reshape(-1) for e in entries]) * pre
        groups[rank].allreduce([fused]).wait()
        return outs, (fused * post).numpy()

    try:
        results = _threads(size, rank_fn)
    finally:
        for group in groups:
            if group is not None:
                group.shutdown()
    return results, cuda_backend.stats["host_ring_bytes_sent"] - before


class _RingMesh:
    """The JAX ring's mesh calls between threads: framed byte sends on a
    queue per (sender, receiver) pair, no digests."""

    def __init__(self, rank: int, boxes):
        self.rank, self.boxes = rank, boxes

    def deferred_digests_for(self, peer: int) -> bool:
        return False

    def send(self, peer, payload, digest=None, wire_dtype=0):
        self.boxes[(self.rank, peer)].put(bytes(payload))

    def recv_into_async(self, peer, dest, digest=None, wire_dtype=0):
        return _Landing(self.boxes[(peer, self.rank)], dest)


class _Landing:
    def __init__(self, box: queue.Queue, dest):
        self.box, self.dest = box, dest

    def wait(self):
        data = self.box.get(timeout=THREAD_TIMEOUT)
        assert len(data) == len(self.dest)
        self.dest[:] = data


def _jax_ring(size: int, inputs, dtype: str, pre: float, post: float):
    """Every rank's outputs of the JAX ``RingAllreduce.execute``."""
    boxes = collections.defaultdict(queue.Queue)
    for i in range(size):
        for j in range(size):
            boxes[(i, j)] = queue.Queue()

    def rank_fn(rank):
        op = jax_cpu_ring.RingAllreduce(
            JaxTopology(rank=rank, size=size, local_size=size),
            _RingMesh(rank, boxes))
        entries = [jax_tensor_queue.TensorTableEntry(f"t{i}", tensor=x)
                   for i, x in enumerate(inputs[rank])]
        response = jax_messages.Response(
            jax_messages.ResponseType.ALLREDUCE,
            [e.tensor_name for e in entries],
            jax_messages.DataType.from_numpy(np.dtype(_NP[dtype])),
            [e.tensor.size for e in entries], prescale_factor=pre,
            postscale_factor=post)
        assert op.execute(response, entries).ok
        return [np.asarray(e.output) for e in entries]

    return _threads(size, rank_fn)


def _ring_bytes(n: int, size: int, itemsize: int, rank: int) -> int:
    """Bytes rank ``rank`` sends in the ring over ``n`` elements: its
    reduce-scatter chunks ``(r − s) mod P`` and allgather chunks
    ``(r + 1 − s) mod P``, s = 0 .. P−2."""
    bounds = cuda_backend.chunk_bounds(n, size)
    sent = [(rank - s) % size for s in range(size - 1)] \
        + [(rank + 1 - s) % size for s in range(size - 1)]
    return itemsize * sum(bounds[c + 1] - bounds[c] for c in sent)


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_narrow_ring_matches_the_jax_ring(size, dtype):
    inputs = _inputs(size, dtype)
    pre, post = 0.5, 3.0 / size
    ours, _ = _port_ring(size, inputs, dtype, pre, post)
    theirs = _jax_ring(size, inputs, dtype, pre, post)
    for rank in range(size):
        for i, n in enumerate(_SIZES):
            assert ours[rank][i].dtype == np.dtype(_NP[dtype])
            assert ours[rank][i].shape == (n,)
            assert ours[rank][i].tobytes() == theirs[rank][i].tobytes(), \
                (rank, i)


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_narrow_ring_hands_the_group_two_bytes_per_element_per_hop(size,
                                                                   dtype):
    n = sum(_SIZES)
    _, sent = _port_ring(size, _inputs(size, dtype), dtype, 1.0, 1.0)
    assert sent == sum(_ring_bytes(n, size, 2, r) for r in range(size))
    # Every element crosses 2·(P−1) hops in all: its two bytes each time.
    assert sent == 2 * (size - 1) * n * 2


def test_narrow_ring_rounds_once_at_two_ranks():
    """Fault C3 stays repaired: at np=2 the one hop's add is the fp32 sum
    of the two values, rounded once."""
    inputs = _inputs(2, "bfloat16")
    ours, _ = _port_ring(2, inputs, "bfloat16", 1.0, 1.0)
    for i in range(len(_SIZES)):
        once = (inputs[0][i].astype(np.float32)
                + inputs[1][i].astype(np.float32)).astype(ml_dtypes.bfloat16)
        for rank in range(2):
            assert ours[rank][i].tobytes() == once.tobytes()


@pytest.mark.parametrize("size", [2, 3])
def test_fp32_keeps_the_gloo_allreduce(size):
    inputs = _inputs(size, "float32")
    results, sent = _port_ring(size, inputs, "float32", 0.5, 0.25,
                               gloo_reference=True)
    assert sent == 0
    for outs, reference in results:
        assert np.concatenate(outs).tobytes() == reference.tobytes()


def test_chunk_bounds_are_the_jax_rings():
    for n in (0, 1, 5, 66, 1001):
        for parts in (1, 2, 3, 4, 7):
            assert cuda_backend.chunk_bounds(n, parts) == \
                [int(b) for b in jax_cpu_ring._chunk_bounds(n, parts)]


# ---------------------------------------------------------------------------
# np=3 through the launcher
# ---------------------------------------------------------------------------

_INPUTS = '''
import ml_dtypes
import numpy as np

def job_inputs(rank):
    rng = np.random.RandomState(500 + rank)
    raw = (rng.randn(3, 1001) * 10.0 ** rng.uniform(-1, 1, (3, 1001)))
    raw = raw.astype(np.float32)
    return {"bf16": raw[0].astype(ml_dtypes.bfloat16),
            "fp16": raw[1].astype(np.float16), "comp": raw[2]}
'''
exec(_INPUTS)

_WORKER = _INPUTS + '''
import json, sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.backend import cuda as cuda_backend

hvd.init(device="cpu")
rank = hvd.rank()
x = job_inputs(rank)
out, sent = {}, {}


def ring(name, fn):
    before = cuda_backend.stats["host_ring_bytes_sent"]
    result = fn()
    sent[name] = cuda_backend.stats["host_ring_bytes_sent"] - before
    out[name] = result


ring("bf16", lambda: hvd.allreduce(
    torch.from_numpy(x["bf16"].view(np.uint16).copy()).view(torch.bfloat16),
    op=hvd.Sum, name="bf16").view(torch.int16).numpy().tobytes().hex())
ring("fp16", lambda: hvd.allreduce(
    torch.from_numpy(x["fp16"].copy()), op=hvd.Average,
    prescale_factor=0.5, name="fp16").numpy().tobytes().hex())
comp, ctx = hvd.Compression.fp16.compress(torch.from_numpy(x["comp"].copy()))
ring("comp", lambda: hvd.Compression.fp16.decompress(
    hvd.allreduce(comp, op=hvd.Sum, name="comp"), ctx).numpy().tobytes().hex())
hvd.shutdown()
with open(f"{sys.argv[1]}/rank{rank}.json", "w") as f:
    json.dump({"out": out, "sent": sent}, f)
print("WORKER_DONE", rank)
'''


@pytest.fixture(scope="module")
def np3_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring_np3")
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "3",
         sys.executable, str(script), str(out)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np=3 job timed out after {JOB_TIMEOUT}s\n{stdout}\n"
                    f"{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(3)]


@pytest.mark.parametrize("name,dtype,pre,post", [
    ("bf16", "bfloat16", 1.0, 1.0),
    ("fp16", "float16", 0.5, 1.0 / 3),
    ("comp", "float16", 1.0, 1.0)])
def test_np3_job_matches_the_jax_ring(np3_job, name, dtype, pre, post):
    inputs = [[job_inputs(r)[name].astype(_NP[dtype])] for r in range(3)]
    theirs = _jax_ring(3, inputs, dtype, pre, post)
    for rank, got in enumerate(np3_job):
        want = theirs[rank][0]
        if name == "comp":      # decompressed: the fp16 result widened
            want = want.astype(np.float32)
        assert got["out"][name] == want.tobytes().hex(), (name, rank)


@pytest.mark.parametrize("name", ["bf16", "fp16", "comp"])
def test_np3_job_sends_narrow_bytes(np3_job, name):
    for rank, got in enumerate(np3_job):
        assert got["sent"][name] == _ring_bytes(1001, 3, 2, rank)
