"""Device allreduce on the card.

Counterpart of ``horovod_tpu/backend/xla.py``, the reference's
``NCCLAllreduce`` role (``nccl_operations.cc:126-191``):

- :class:`CudaAllreduce` plays ``XlaAllreduce.execute`` at size 1
  (``xla.py:578-612`` with ``local_allreduce``, :276-305): the sum over one
  rank is the identity, so it applies ``prescale·postscale``.
- :class:`NcclAllreduce` plays it at size > 1 (``allreduce_fn``,
  :246-274): :func:`fuse` the entries into one buffer, sum it over the NCCL
  group, :func:`unfuse` into the outputs.  This is the device plane,
  ``HOROVOD_DATA_PLANE=nccl``.

Both widen floats of 16 bits or fewer to fp32 before any arithmetic and cast
back at the end, as ``xla.py:257-270`` does, so a bf16 sum over ranks adds
in fp32.  The fused buffer holds exactly the entries' elements: the JAX
package pads it to a power-of-two bucket to spare XLA recompiles, which
NCCL does not need, so no padding exists to reach an output.  Plain torch
ops: the JAX package leaves this arithmetic to XLA, not to Pallas.

CUDA tensors run on the op's own stream, after waiting on each entry's ready
event (recorded on the caller's stream at enqueue; autograd may produce a
gradient on another stream than this one).  The op records one done event
and returns ``Status.in_progress()``; the runtime's finalizer thread waits
on that event before firing callbacks (reference ``gpu_operations.h:98-127``).
CPU tensors are reduced at once with the same arithmetic (size 1 only).
"""

from __future__ import annotations

import datetime
from typing import Dict, List

import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError
from ..common.topology import ProcessTopology
from ..core.messages import Response, ResponseType
from ..core.operation_manager import CollectiveOp
from ..core.tensor_queue import Status, TensorTableEntry

#: Counts kept by the allreduce ops, this module's and the host plane's:
#: ``allreduce_responses`` (responses executed) and ``allreduce_tensors``
#: (entries reduced), so a run can show that tensors went through them.
stats: Dict[str, int] = {"allreduce_responses": 0, "allreduce_tensors": 0}


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


def count(entries: List[TensorTableEntry]) -> None:
    stats["allreduce_responses"] += 1
    stats["allreduce_tensors"] += len(entries)


def nccl_group(store: "dist.Store", rank: int, size: int,
               timeout: float) -> "dist.ProcessGroupNCCL":
    """The device plane's NCCL group of ``size`` ranks, rendezvoused
    through ``store``; the runtime's own, not torch.distributed's default
    group.  Its communicator comes up at the first collective."""
    options = dist.ProcessGroupNCCL.Options()
    options._timeout = datetime.timedelta(seconds=timeout)
    return dist.ProcessGroupNCCL(store, rank, size, options)


class CudaAllreduce(CollectiveOp):
    """Size 1: ``prescale·postscale`` into each output."""

    def __init__(self, topo: ProcessTopology, device: torch.device):
        self.topo = topo
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

    def enabled(self, response: Response,
                entries: List[TensorTableEntry]) -> bool:
        return (response.response_type == ResponseType.ALLREDUCE
                and self.topo.size == 1
                and all(e.tensor is not None for e in entries))

    def execute(self, response: Response,
                entries: List[TensorTableEntry]) -> Status:
        scale = response.prescale_factor * response.postscale_factor
        count(entries)
        if response.devices == [-1]:
            for e in entries:
                if e.output is None:
                    e.output = torch.empty_like(e.tensor)
                _reduce_into(e.tensor, e.output, scale)
            return Status.OK()
        stream = self.stream
        with torch.cuda.stream(stream):
            wait_ready(stream, entries)
            for e in entries:
                if e.output is None:
                    e.output = torch.empty_like(e.tensor)
                    e.output.record_stream(e.ready_stream)
                _reduce_into(e.tensor, e.output, scale)
            return record_done(stream, entries)


class NcclAllreduce(CollectiveOp):
    """Size > 1 on the device plane: fuse, ``allreduce`` on the NCCL
    ``group`` (:func:`nccl_group`) from the op's stream, unfuse.  Takes
    CUDA tensors only."""

    def __init__(self, topo: ProcessTopology, device: torch.device, group):
        self.topo = topo
        self.group = group
        self.stream = torch.cuda.Stream(device)

    def enabled(self, response: Response,
                entries: List[TensorTableEntry]) -> bool:
        return response.response_type == ResponseType.ALLREDUCE \
            and self.topo.size > 1

    def execute(self, response: Response,
                entries: List[TensorTableEntry]) -> Status:
        if -1 in response.devices:
            raise HorovodInternalError(
                f"{env_mod.HOROVOD_DATA_PLANE}={env_mod.PLANE_NCCL} reduces "
                f"tensors on the card, but a rank sent a CPU tensor in "
                f"{response.tensor_names}; use "
                f"{env_mod.HOROVOD_DATA_PLANE}={env_mod.PLANE_HOST}")
        count(entries)
        stream = self.stream
        with torch.cuda.stream(stream):
            wait_ready(stream, entries)
            fused = fuse(entries, response.prescale_factor)
            # The NCCL stream waits on this one, and this one on it.
            self.group.allreduce([fused]).wait()
            unfuse(fused, entries, response.postscale_factor)
            return record_done(stream, entries)
