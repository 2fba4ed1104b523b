"""The host plane: the cross-rank allreduce summed on the host over the gloo
control group (``HOROVOD_DATA_PLANE=cpu``, the default at size > 1).

Counterpart of ``horovod_tpu/backend/cpu_ring.py::RingAllreduce``, the JAX
package's default data plane at size > 1.  The port does not carry the ring
over its own TCP mesh: ``torch.distributed.all_reduce`` on the gloo group
that already carries the negotiation does the sum.  Where the ring sends
bf16 and fp16 narrow and rounds at every hop (``cpu_ring.py:106-112,
180-194``), this plane widens the whole fused buffer to fp32 first and
rounds once at the end, as the device plane does (``backend/cuda.py``).

CUDA entries: the op's stream waits on each ready event, fuses, widens and
prescales on the card, and copies the buffer to the host; gloo sums it; the
sum is copied back on the op's stream, postscaled, cast and unfused into
the outputs, and one done event is recorded for the finalizer.  CPU
entries take the same steps with no copies.
"""

from __future__ import annotations

from typing import List

import torch

from ..common.exceptions import HorovodInternalError
from ..common.topology import ProcessTopology
from ..core.messages import Response, ResponseType
from ..core.operation_manager import CollectiveOp
from ..core.tensor_queue import Status, TensorTableEntry
from .cuda import count, fuse, record_done, unfuse, wait_ready


class HostAllreduce(CollectiveOp):
    """``group`` is the runtime's gloo control group
    (:func:`~horovod_tpu_torch.transport.control.gloo_group`).  Counts
    into ``backend.cuda.stats``, as the device ops do."""

    def __init__(self, topo: ProcessTopology, device: torch.device, group):
        self.topo = topo
        self.device = device
        self.group = group
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None

    def enabled(self, response: Response,
                entries: List[TensorTableEntry]) -> bool:
        return response.response_type == ResponseType.ALLREDUCE \
            and self.topo.size > 1

    def execute(self, response: Response,
                entries: List[TensorTableEntry]) -> Status:
        kinds = {e.tensor.device.type for e in entries}
        if len(kinds) != 1:
            raise HorovodInternalError(
                f"rank {self.topo.rank} holds CPU and CUDA tensors in one "
                f"fused allreduce ({response.tensor_names}); give each "
                "tensor the same device on every rank")
        count(entries)
        if kinds == {"cpu"}:
            fused = fuse(entries, response.prescale_factor)
            self.group.allreduce([fused]).wait()
            unfuse(fused, entries, response.postscale_factor)
            return Status.OK()
        stream = self.stream
        with torch.cuda.stream(stream):
            wait_ready(stream, entries)
            # Waits for this stream's work: the fused buffer is complete.
            host = fuse(entries, response.prescale_factor).cpu()
        self.group.allreduce([host]).wait()
        with torch.cuda.stream(stream):
            unfuse(host.to(self.device), entries, response.postscale_factor)
            return record_done(stream, entries)
