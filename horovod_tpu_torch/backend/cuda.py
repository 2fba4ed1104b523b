"""Device allreduce on the card.

Counterpart of ``horovod_tpu/backend/xla.py``: :class:`CudaAllreduce` plays
``XlaAllreduce.execute`` (:578-612) with ``XlaContext.local_allreduce``
(:276-305), the reference's ``NCCLAllreduce`` role
(``nccl_operations.cc:126-191``).  At one process the sum over ranks is the
identity, so the op applies ``prescale·postscale`` — widening floats of 16
bits or fewer to fp32 first and casting back — and writes each entry's
output.  Plain torch ops: the JAX package leaves this to XLA, not to Pallas.
The size > 1 branch (fuse → NCCL → unfuse) arrives with the transport slice.

CUDA tensors run on the op's own stream, after waiting on each entry's ready
event (recorded on the caller's stream at enqueue; autograd may produce a
gradient on another stream than this one).  The op records one done event
and returns ``Status.in_progress()``; the runtime's finalizer thread waits
on that event before firing callbacks (reference ``gpu_operations.h:98-127``).
CPU tensors are reduced at once with the same arithmetic.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..common.topology import ProcessTopology
from ..core.messages import Response, ResponseType
from ..core.operation_manager import CollectiveOp
from ..core.tensor_queue import Status, TensorTableEntry

#: Counts kept by the ops: ``allreduce_responses`` (responses executed) and
#: ``allreduce_tensors`` (entries reduced), so a run can show that tensors
#: went through this op.
stats: Dict[str, int] = {"allreduce_responses": 0, "allreduce_tensors": 0}


def _reduce_into(tensor: torch.Tensor, out: torch.Tensor,
                 scale: float) -> None:
    """``out = cast(widen(tensor) * scale)``: the single-rank sum."""
    if scale == 1.0:
        if out is not tensor:
            out.copy_(tensor)
        return
    widen = tensor.is_floating_point() and tensor.element_size() <= 2
    acc = tensor.float() if widen else tensor
    out.copy_(acc * scale)


class CudaAllreduce(CollectiveOp):
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
        stats["allreduce_responses"] += 1
        stats["allreduce_tensors"] += len(entries)
        if response.devices == [-1]:
            for e in entries:
                if e.output is None:
                    e.output = torch.empty_like(e.tensor)
                _reduce_into(e.tensor, e.output, scale)
            return Status.OK()
        stream = self.stream
        with torch.cuda.stream(stream):
            for e in entries:
                stream.wait_event(e.ready_event)
                # The caching allocator must not hand these blocks to other
                # work while the other stream still uses them.
                e.tensor.record_stream(stream)
                if e.output is None:
                    e.output = torch.empty_like(e.tensor)
                    e.output.record_stream(e.ready_stream)
                _reduce_into(e.tensor, e.output, scale)
            done = torch.cuda.Event()
            done.record(stream)
        for e in entries:
            e.done_event = done
        return Status.in_progress()
