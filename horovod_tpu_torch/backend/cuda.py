"""The collectives: allreduce, and the broadcast, allgather and alltoall
that move bits.  Each is one class, built once for each plane the runtime
runs (``core/state.py::register_ops``):

- ``LOCAL``, size 1 (``XlaAllreduce.execute`` with ``local_allreduce``,
  ``horovod_tpu/backend/xla.py:276-305, 578-612``): the sum over one rank
  is the identity, so the allreduce applies ``prescale·postscale``; the
  others copy into the outputs.
- ``PLANE_NCCL``, the device plane (``HOROVOD_DATA_PLANE=nccl``; the
  reference's ``NCCLAllreduce``, ``nccl_operations.cc:126-191``): the
  exchange on the runtime's NCCL group (:func:`nccl_group`) from the op's
  stream.
- ``PLANE_HOST``, the host plane (the default at size > 1; the roles of
  ``horovod_tpu/backend/cpu_ring.py``'s ``RingAllreduce``,
  ``TreeBroadcast`` :790, ``RingAllgather`` :701 and ``PairwiseAlltoall``
  :876): the exchange on the runtime's gloo group, CUDA buffers copied to
  the host on the op's stream before it and back after it.  gloo's
  allreduce does the sum, not a ring over the port's own TCP mesh.

:func:`plane_takes` picks the op: at size > 1 the device plane's takes a
response whose tensors lie on the card on every rank and refuses one that
mixes the CPU and the card across ranks (reference Horovod's "Mismatched
CPU/GPU device selection"); a response on the CPU on every rank (AdamW's
0-d ``step``, the object collectives' bytes) takes the host plane's.

The device plane's allreduce fuses the entries into one buffer
(:func:`fuse`), widening floats of 16 bits or fewer to fp32 as
``xla.py:257-270`` does, sums it and unfuses it (:func:`unfuse`), so a
bf16 sum over ranks adds in fp32 and rounds once.  The host plane does the
same for every other dtype (gloo's allreduce, fp32, fp64 and integers
summed in their own dtype).  A bf16 or fp16 response on the host plane
instead keeps its dtype on the wire, as the JAX ``RingAllreduce`` does
(``cpu_ring.py:517-535``): fused narrow, prescaled (widened, scaled,
rounded back), reduced by a ring over the group's send/recv (a
reduce-scatter whose every hop adds in fp32 and rounds back once,
``_widen_add``, then an allgather of the owned chunks, with the JAX
ring's chunk bounds and hop order), then postscaled the same way; so each
element moves ``2·(P−1)/P`` times its two bytes, and at np=2 it rounds
once, as the widened sum does.
The fused buffer holds exactly the entries' elements: the JAX package pads
it to a power-of-two bucket to spare XLA recompiles, which neither group
needs.  The bit-moving collectives (``XlaBroadcast`` :950,
``XlaAllgather`` :615, ``XlaAlltoall`` :698) work on each entry's bytes,
so every dtype moves exactly: the allgather pads each rank's block to the
widest rank's (ragged first dimensions), the alltoall runs
``alltoall_base`` with the response's split column.  Plain torch ops and
group calls: the JAX package leaves this to XLA, not to Pallas.

With a timeline active (``core/timeline.py``), the host plane's allreduce
emits the JAX ring's lifecycle spans on each member tensor's lane
(``LC_FUSE``, ``LC_WIRE_REDUCE_SCATTER``, ``LC_WIRE_ALLGATHER``,
``LC_UNFUSE``; ``LC_RS_STEP``/``LC_AG_STEP`` per hop on the first lane),
except that gloo's fp32, fp64 and integer sum is one opaque call: one
``LC_WIRE_REDUCE_SCATTER`` holds it, and no allgather or hop span
follows.  The other ops, and every op on the device plane and at size 1,
emit no lifecycle spans of their own.

CUDA tensors run on the op's own stream, after waiting on each entry's ready
event (recorded on the caller's stream at enqueue; autograd may produce a
gradient on another stream than this one).  The op records one done event
and returns ``Status.in_progress()``; the runtime's finalizer thread waits
on that event before firing callbacks (reference ``gpu_operations.h:98-127``).
CPU tensors take the same steps at once, with no stream and no copies.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..common.env import HOROVOD_DATA_PLANE, PLANE_HOST, PLANE_NCCL
from ..common.exceptions import HorovodInternalError
from ..common.topology import ProcessTopology
from ..core import timeline as timeline_mod
from ..core.messages import Response
from ..core.operation_manager import CollectiveOp
from ..core.tensor_queue import Status, TensorTableEntry
from ..transport import control

#: Counts kept by the ops of this module and of the host plane, per
#: collective: ``<kind>_responses`` (responses executed) and
#: ``<kind>_tensors`` (entries), so a run can show that tensors went
#: through them.
stats: Dict[str, int] = {f"{kind}_{what}": 0
                         for kind in ("allreduce", "adasum", "broadcast",
                                      "allgather", "alltoall")
                         for what in ("responses", "tensors")}
#: Bytes the host plane's narrow ring handed to the group's ``send``.
stats["host_ring_bytes_sent"] = 0


def widened(tensor: torch.Tensor) -> torch.Tensor:
    """fp32 for floats of 16 bits or fewer (the precision every sum and
    scale runs in), else the tensor itself."""
    if tensor.is_floating_point() and tensor.element_size() <= 2:
        return tensor.float()
    return tensor


def fuse(entries: List[TensorTableEntry], prescale: float) -> torch.Tensor:
    """One new flat buffer of every entry's widened, prescaled elements, in
    entry order (``XlaContext.fuse`` without the bucket padding).  An
    integer tensor with a prescale other than 1 becomes fp32, as in XLA."""
    parts = []
    for e in entries:
        acc = widened(e.tensor).reshape(-1)
        parts.append(acc * prescale if prescale != 1.0 else acc)
    return torch.cat(parts)


def unfuse(fused: torch.Tensor, entries: List[TensorTableEntry],
           postscale: float) -> None:
    """Postscale the summed buffer, cast each entry's slice back to its
    dtype and write it into the entry's output (allocated when the flavor
    is out of place)."""
    if postscale != 1.0:
        fused = fused * postscale
    offset = 0
    for e in entries:
        n = e.tensor.numel()
        if e.output is None:
            e.output = torch.empty_like(e.tensor)
            if e.ready_stream is not None:
                # Allocated on the op's stream, used on the caller's.
                e.output.record_stream(e.ready_stream)
        e.output.copy_(fused[offset:offset + n].view(e.tensor.shape))
        offset += n


def _reduce_into(tensor: torch.Tensor, out: torch.Tensor,
                 scale: float) -> None:
    """``out = cast(widen(tensor) * scale)``: the single-rank sum."""
    if scale == 1.0:
        if out is not tensor:
            out.copy_(tensor)
        return
    out.copy_(widened(tensor) * scale)


def wait_ready(stream, entries: List[TensorTableEntry]) -> None:
    """Order ``stream`` after each entry's ready event, and keep the
    caching allocator from handing the input's blocks to other work while
    ``stream`` still reads them."""
    for e in entries:
        stream.wait_event(e.ready_event)
        e.tensor.record_stream(stream)


def record_done(stream, entries: List[TensorTableEntry]) -> Status:
    done = torch.cuda.Event()
    done.record(stream)
    for e in entries:
        e.done_event = done
    return Status.in_progress()


def entries_device(response: Response,
                   entries: List[TensorTableEntry]) -> torch.device:
    """The one device of this rank's entries in ``response``."""
    devices = {e.tensor.device for e in entries}
    if len(devices) != 1:
        raise HorovodInternalError(
            f"rank holds tensors on {sorted(map(str, devices))} in one "
            f"fused {response.response_type.name.lower()} "
            f"({response.tensor_names}); give each tensor the same device "
            "on every rank")
    return devices.pop()


def nccl_group(store: "dist.Store", rank: int, size: int,
               timeout: float) -> "dist.ProcessGroupNCCL":
    """The device plane's NCCL group of ``size`` ranks, rendezvoused
    through ``store``; the runtime's own, not torch.distributed's default
    group.  Its communicator comes up at the first collective."""
    options = dist.ProcessGroupNCCL.Options()
    options._timeout = datetime.timedelta(seconds=timeout)
    return dist.ProcessGroupNCCL(store, rank, size, options)


#: The plane of an op at size 1.
LOCAL = "local"


def plane_takes(plane: str, size: int, response: Response) -> bool:
    """Whether the op built for ``plane`` runs ``response``.  Every rank
    reads the same size and negotiated devices, so every rank picks the
    same op.  The device plane's op stands before the host plane's in the
    chain: the host plane's takes what the device plane's leaves, and at
    ``HOROVOD_DATA_PLANE=cpu`` everything."""
    if size == 1:
        return plane == LOCAL
    if plane == PLANE_NCCL:
        return any(d >= 0 for d in response.devices)
    return plane == PLANE_HOST


class PlaneOp(CollectiveOp):
    """The flow shared by the collectives: ``group`` is None at size 1,
    else the NCCL group (``plane`` PLANE_NCCL) or the gloo group
    (PLANE_HOST)."""

    KIND: str

    def __init__(self, topo: ProcessTopology, device: torch.device,
                 plane: str = LOCAL, group=None):
        self.topo = topo
        self.device = device
        self.plane = plane
        self.group = group
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

    def enabled(self, response: Response,
                entries: List[TensorTableEntry]) -> bool:
        return plane_takes(self.plane, self.topo.size, response)

    def execute(self, response: Response,
                entries: List[TensorTableEntry]) -> Status:
        if self.plane == PLANE_NCCL and -1 in response.devices:
            raise HorovodInternalError(
                f"Mismatched CPU/GPU device selection for "
                f"{response.tensor_names}: some ranks hold the tensor on the "
                f"CPU and others on the card; {HOROVOD_DATA_PLANE}="
                f"{PLANE_NCCL} moves tensors on the card only (the host "
                f"plane, {HOROVOD_DATA_PLANE}={PLANE_HOST}, takes both)")
        device = entries_device(response, entries)
        stats[f"{self.KIND}_responses"] += 1
        stats[f"{self.KIND}_tensors"] += len(entries)
        if device.type == "cpu":
            self._run(response, entries, device)
            return Status.OK()
        stream = self.stream
        with torch.cuda.stream(stream):
            wait_ready(stream, entries)
            self._run(response, entries, device)
            return record_done(stream, entries)

    def _wait(self, work) -> None:
        """A host-plane collective's wait can be aborted
        (``transport/control.py``); a device-plane one only orders the
        streams."""
        if self.plane == PLANE_HOST:
            control.wait(work)
        else:
            work.wait()

    def _wire(self, device: torch.device) -> torch.device:
        """Where the group's buffers lie: the host for the host plane
        (copying a CUDA buffer there waits for the op's stream, so a sent
        buffer is complete), else ``device``."""
        return torch.device("cpu") if self.plane == PLANE_HOST else device

    @staticmethod
    def _place(e: TensorTableEntry, out: torch.Tensor) -> None:
        """Hand a new output tensor to the entry: allocated on the op's
        stream, used on the caller's."""
        if e.ready_stream is not None:
            out.record_stream(e.ready_stream)
        e.output = out

    def _run(self, response: Response, entries: List[TensorTableEntry],
             device: torch.device) -> None:
        raise NotImplementedError


class Allreduce(PlaneOp):
    """Size 1: ``prescale·postscale`` into each output.  Size > 1: fuse,
    ``allreduce`` on the group, unfuse."""

    KIND = "allreduce"

    def _run(self, response, entries, device):
        if self.group is None:
            scale = response.prescale_factor * response.postscale_factor
            for e in entries:
                if e.output is None:
                    self._place(e, torch.empty_like(e.tensor))
                _reduce_into(e.tensor, e.output, scale)
            return
        if self.plane == PLANE_HOST:
            sample = entries[0].tensor
            if sample.is_floating_point() and sample.element_size() == 2:
                self._narrow_ring(response, entries, device)
            else:
                self._host_sum(response, entries, device)
            return
        fused = fuse(entries, response.prescale_factor)
        # The NCCL stream waits on this one, and this one on it.
        self.group.allreduce([fused]).wait()
        unfuse(fused, entries, response.postscale_factor)

    def _host_sum(self, response, entries, device) -> None:
        """The host plane's fp32, fp64 and integer allreduce: fuse and copy
        to the host (the copy waits on the op's stream, so the gradients'
        ready events), gloo's sum, copy back and unfuse.  The spans are the
        JAX ring's (``cpu_ring.py``), with one difference: gloo's allreduce
        is one opaque call, so one ``LC_WIRE_REDUCE_SCATTER`` holds its
        whole exchange, and no ``LC_WIRE_ALLGATHER`` or per-hop span
        follows.  ``phase_stats`` gets ``fuse``, ``collective`` and
        ``unfuse`` (``horovod_tpu/backend/xla.py:591-610``)."""
        lanes = timeline_mod.lifecycle_lanes(entries)
        phases = timeline_mod.phase_stats
        t0 = time.monotonic()
        timeline_mod.lifecycle_span(lanes, "LC_FUSE", True)
        fused = fuse(entries, response.prescale_factor).to("cpu")
        timeline_mod.lifecycle_span(lanes, "LC_FUSE", False)
        t1 = time.monotonic()
        phases.add("fuse", t1 - t0)
        timeline_mod.lifecycle_span(lanes, "LC_WIRE_REDUCE_SCATTER", True)
        control.wait(self.group.allreduce([fused]))
        timeline_mod.lifecycle_span(lanes, "LC_WIRE_REDUCE_SCATTER", False)
        t2 = time.monotonic()
        phases.add("collective", t2 - t1)
        timeline_mod.lifecycle_span(lanes, "LC_UNFUSE", True)
        unfuse(fused.to(device), entries, response.postscale_factor)
        timeline_mod.lifecycle_span(lanes, "LC_UNFUSE", False)
        phases.add("unfuse", time.monotonic() - t2)

    def _narrow_ring(self, response, entries, device) -> None:
        """The host plane's bf16/fp16 allreduce (module docstring):
        ``RingAllreduce.execute`` without its codecs and error feedback,
        with its lifecycle spans (``cpu_ring.py:533-600``)."""
        lanes = timeline_mod.lifecycle_lanes(entries)
        timeline_mod.lifecycle_span(lanes, "LC_FUSE", True)
        buf = torch.cat([e.tensor.reshape(-1) for e in entries]).to("cpu")
        timeline_mod.lifecycle_span(lanes, "LC_FUSE", False)
        buf = scaled_narrow(buf, response.prescale_factor)
        ring_allreduce(buf, self.topo.rank, self.topo.size, self._exchange,
                       lanes)
        buf = scaled_narrow(buf, response.postscale_factor)
        timeline_mod.lifecycle_span(lanes, "LC_UNFUSE", True)
        unfuse(buf.to(device), entries, 1.0)
        timeline_mod.lifecycle_span(lanes, "LC_UNFUSE", False)

    def _exchange(self, send: torch.Tensor, recv: torch.Tensor) -> None:
        """One ring hop: ``send`` to the next rank and the previous rank's
        chunk into ``recv``, both posted before either is waited on (as
        bytes: gloo's send/recv take no bf16)."""
        rank, size = self.topo.rank, self.topo.size
        works = []
        if recv.numel():
            works.append(self.group.recv([recv.view(torch.uint8)],
                                         (rank - 1) % size, 0))
        if send.numel():
            works.append(self.group.send([send.view(torch.uint8)],
                                         (rank + 1) % size, 0))
            stats["host_ring_bytes_sent"] += send.numel() * send.element_size()
        # Waited on whole: a timed wait would end a send or receive.
        for work in works:
            work.wait()


def scaled_narrow(buf: torch.Tensor, factor: float) -> torch.Tensor:
    """``buf · factor`` in fp32, rounded back to ``buf``'s dtype
    (``cpu_ring.py::_scale_inplace``); ``buf`` itself when the factor is 1."""
    if factor == 1.0:
        return buf
    return (buf.float() * factor).to(buf.dtype)


def chunk_bounds(n: int, parts: int) -> List[int]:
    """The ring's chunk offsets: ``parts`` chunks of ``n`` elements, the
    first ``n % parts`` one longer (``cpu_ring.py::_chunk_bounds``)."""
    base, rem = divmod(n, parts)
    bounds = [0]
    for c in range(parts):
        bounds.append(bounds[-1] + base + (1 if c < rem else 0))
    return bounds


def ring_allreduce(buf: torch.Tensor, rank: int, size: int,
                   exchange, lanes: Sequence[str] = ()) -> None:
    """Sum ``buf`` (flat, contiguous, on the host) over ``size`` ranks in
    place, in its own dtype: the JAX ring's reduce-scatter (at hop s rank r
    sends chunk ``(r − s) mod P`` and adds the incoming chunk
    ``(r − s − 1) mod P`` into its own, widened and rounded back once),
    after which rank r owns chunk ``(r + 1) mod P``, then its allgather (at
    hop s rank r sends chunk ``(r + 1 − s) mod P`` and receives chunk
    ``(r − s) mod P`` in place).  ``exchange(send, recv)`` sends to rank
    ``r + 1`` and receives from rank ``r − 1``.  ``lanes`` are the fused
    tensors' timeline lanes: each phase's ``LC_WIRE_*`` span on every one,
    each hop's ``LC_RS_STEP``/``LC_AG_STEP`` on the first only
    (``cpu_ring.py:413-451``)."""
    bounds = chunk_bounds(buf.numel(), size)
    stage = torch.empty(bounds[1] - bounds[0], dtype=buf.dtype)
    span = timeline_mod.lifecycle_span
    step_lane = lanes[:1]

    def chunk(c: int) -> torch.Tensor:
        return buf[bounds[c]:bounds[c + 1]]

    span(lanes, "LC_WIRE_REDUCE_SCATTER", True)
    for s in range(size - 1):
        span(step_lane, "LC_RS_STEP", True)
        mine = chunk((rank - s - 1) % size)
        incoming = stage[:mine.numel()]
        exchange(chunk((rank - s) % size), incoming)
        mine.copy_((mine.float() + incoming.float()).to(buf.dtype))
        span(step_lane, "LC_RS_STEP", False)
    span(lanes, "LC_WIRE_REDUCE_SCATTER", False)
    span(lanes, "LC_WIRE_ALLGATHER", True)
    for s in range(size - 1):
        span(step_lane, "LC_AG_STEP", True)
        exchange(chunk((rank + 1 - s) % size), chunk((rank - s) % size))
        span(step_lane, "LC_AG_STEP", False)
    span(lanes, "LC_WIRE_ALLGATHER", False)


# ---------------------------------------------------------------------------
# broadcast, allgather, alltoall: bits moved as bytes
# ---------------------------------------------------------------------------


def as_bytes(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor's elements as flat bytes (a view when it is contiguous)."""
    return tensor.reshape(-1).view(torch.uint8)


def typed(buf: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """Bytes back as a tensor of ``dtype`` and ``shape`` (a view)."""
    return buf.view(dtype).reshape(shape)


class Broadcast(PlaneOp):
    """Size 1: the root's tensor into the output (a copy for the
    out-of-place flavor; nothing for the in-place one).  Size > 1: the
    other ranks receive the root's bytes."""

    KIND = "broadcast"

    def _run(self, response, entries, device):
        e = entries[0]
        src = e.tensor
        if self.group is None or self.topo.rank == e.root_rank:
            if e.output is None:
                self._place(e, src.clone())
            elif e.output is not src:
                e.output.copy_(src)
            if self.group is not None:
                self._wait(self.group.broadcast(
                    [as_bytes(src).to(self._wire(device))], self._root(e)))
            return
        buf = torch.empty(src.numel() * src.element_size(),
                          dtype=torch.uint8, device=self._wire(device))
        self._wait(self.group.broadcast([buf], self._root(e)))
        out = typed(buf.to(device), src.dtype, src.shape)
        if e.output is None:
            self._place(e, out)
        else:
            e.output.copy_(out)

    @staticmethod
    def _root(e: TensorTableEntry) -> "dist.BroadcastOptions":
        options = dist.BroadcastOptions()
        options.rootRank = e.root_rank
        return options


class Allgather(PlaneOp):
    """Size 1: a copy of each tensor.  Size > 1: one block of this rank's
    entries' bytes, padded to the widest rank's block, is gathered from
    every rank; each output is its tensor's rows of every rank's block, in
    rank order (the JAX ``RingAllgather``'s layout)."""

    KIND = "allgather"

    def _run(self, response, entries, device):
        size, k = self.topo.size, len(entries)
        # tensor_sizes: k blocks of ``size`` first dimensions; tensor i's
        # rows on rank r are tensor_sizes[i * size + r].
        rows = response.tensor_sizes
        row_bytes = [_row_bytes(e.tensor) for e in entries]
        widths = [sum(rows[i * size + r] * row_bytes[i] for i in range(k))
                  for r in range(size)]
        own = torch.zeros(max(widths), dtype=torch.uint8, device=device)
        own[:widths[self.topo.rank]] = torch.cat(
            [as_bytes(e.tensor) for e in entries])
        if self.group is None:
            blocks = [own]
        else:
            own = own.to(self._wire(device))
            blocks = [torch.empty_like(own) for _ in range(size)]
            self._wait(self.group.allgather([blocks], [own]))
            blocks = [b.to(device) for b in blocks]
        for i, e in enumerate(entries):
            parts = []
            for r in range(size):
                off = sum(rows[j * size + r] * row_bytes[j] for j in range(i))
                n = rows[i * size + r] * row_bytes[i]
                parts.append(blocks[r][off:off + n])
            shape = (sum(rows[i * size:(i + 1) * size]),) \
                + tuple(e.tensor.shape[1:])
            self._place(e, typed(torch.cat(parts), e.tensor.dtype, shape))


def _row_bytes(tensor: torch.Tensor) -> int:
    """Bytes of one row along the first dimension."""
    n = tensor.element_size()
    for d in tensor.shape[1:]:
        n *= d
    return n


class Alltoall(PlaneOp):
    """Size 1: a copy of the tensor.  Size > 1: this rank's rows go out by
    its splits and come back by the response's split column
    (``alltoall_base`` on the rows' bytes); ``received_splits`` holds the
    rows received from each rank."""

    KIND = "alltoall"

    def _run(self, response, entries, device):
        e = entries[0]
        size, rank = self.topo.size, self.topo.rank
        # Row r of the N x N matrix is rank r's send splits.
        matrix = response.tensor_sizes
        send = matrix[rank * size:(rank + 1) * size]
        recv = [matrix[r * size + rank] for r in range(size)]
        e.received_splits = recv
        row = _row_bytes(e.tensor)
        buf = as_bytes(e.tensor)
        if self.group is None:
            buf = buf.clone()
        else:
            wire = self._wire(device)
            out = torch.empty(sum(recv) * row, dtype=torch.uint8,
                              device=wire)
            self._wait(self.group.alltoall_base(
                out, buf.to(wire), [n * row for n in recv],
                [n * row for n in send], dist.AllToAllOptions()))
            buf = out.to(device)
        self._place(e, typed(buf, e.tensor.dtype,
                             (sum(recv),) + tuple(e.tensor.shape[1:])))
