"""The coordination controller — agreement on which named tensors are ready,
every cycle.

Counterpart of ``horovod_tpu/core/controller.py`` (the reference's
``horovod/common/controller.cc:97-525``, ``ComputeResponseList``), ported
for one process: every request is tallied in the message table, a tensor
requested by every rank becomes a validated Response
(``ConstructResponse``, ``controller.cc:547-824``), and the cycle's
responses are fused under the fusion threshold (``FuseResponses``,
``controller.cc:859-998``).  The coordinator/worker rounds, the response
cache, negotiation fan-in, straggler detection and the stall inspector run
only across ranks and arrive with the transport slice (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set

from ..common.exceptions import HorovodInternalError
from ..common.logging_util import get_logger
from ..common.topology import ProcessTopology
from .messages import (
    Request,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
)

log = get_logger("horovod_tpu_torch.controller")

_RESPONSE_TYPE = {
    RequestType.ALLREDUCE: ResponseType.ALLREDUCE,
    RequestType.ALLGATHER: ResponseType.ALLGATHER,
    RequestType.BROADCAST: ResponseType.BROADCAST,
    RequestType.ADASUM: ResponseType.ADASUM,
    RequestType.ALLTOALL: ResponseType.ALLTOALL,
    RequestType.BARRIER: ResponseType.BARRIER,
}


@dataclass
class _TableEntry:
    requests: List[Request] = field(default_factory=list)
    ranks: Set[int] = field(default_factory=set)


class Controller:
    def __init__(self, topology: ProcessTopology,
                 fusion_threshold_bytes: int = 64 * 1024 * 1024,
                 stall_warning_secs: float = 60.0,
                 stall_shutdown_secs: float = 0.0):
        self.topo = topology
        self.fusion_threshold = fusion_threshold_bytes
        # Read by the stall inspector, which runs in the cross-rank rounds.
        self.stall_warning_secs = stall_warning_secs
        self.stall_shutdown_secs = stall_shutdown_secs
        self._message_table: Dict[str, _TableEntry] = {}

    def compute_response_list(self, requests: List[Request],
                              should_shutdown: bool = False) -> ResponseList:
        """One negotiation round over this cycle's requests."""
        if self.topo.size != 1:
            raise HorovodInternalError(
                "the cross-rank negotiation rounds arrive with the transport "
                "slice (ROADMAP.md); this runtime runs one process")
        return self._single_process_responses(requests, should_shutdown)

    def _single_process_responses(self, requests: List[Request],
                                  should_shutdown: bool) -> ResponseList:
        responses = []
        for req in requests:
            if self._increment(req):
                responses.append(self._construct_response(req.tensor_name))
        return ResponseList(responses=self._fuse_responses(responses),
                            shutdown=should_shutdown)

    # ------------------------------------------------------------------
    # message table
    # ------------------------------------------------------------------

    def _increment(self, req: Request) -> bool:
        """Tally one rank's readiness; True when every rank has requested
        the tensor (``IncrementTensorCount``, ``controller.cc:1030-1053``)."""
        entry = self._message_table.setdefault(req.tensor_name, _TableEntry())
        if req.request_rank in entry.ranks:
            log.warning("rank %d re-submitted tensor %s before completion",
                        req.request_rank, req.tensor_name)
            return False
        entry.ranks.add(req.request_rank)
        entry.requests.append(req)
        return len(entry.ranks) == self.topo.size

    # ------------------------------------------------------------------
    # response construction & validation
    # ------------------------------------------------------------------

    def _construct_response(self, name: str) -> Response:
        """Validate cross-rank consistency and emit the Response: any
        dtype/op/scale/shape disagreement becomes an ERROR response that is
        delivered to the waiting callback."""
        reqs = self._message_table.pop(name).requests
        first = reqs[0]
        error = None
        for req in reqs[1:]:
            if req.tensor_type != first.tensor_type:
                error = (f"Mismatched data types for {name}: rank "
                         f"{first.request_rank} sent {first.tensor_type.name}, "
                         f"rank {req.request_rank} sent {req.tensor_type.name}.")
            elif req.request_type != first.request_type:
                error = (f"Mismatched operations for {name}: ranks disagree on "
                         f"{first.request_type.name} vs {req.request_type.name}.")
            elif (req.prescale_factor != first.prescale_factor
                  or req.postscale_factor != first.postscale_factor):
                error = f"Mismatched pre/postscale factors for {name}."
            elif req.tensor_shape != first.tensor_shape:
                error = (f"Mismatched {first.request_type.name.lower()} tensor "
                         f"shapes for {name}: rank {first.request_rank} has "
                         f"{first.tensor_shape}, rank {req.request_rank} has "
                         f"{req.tensor_shape}.")
            if error is not None:
                return Response(response_type=ResponseType.ERROR,
                                tensor_names=[name], error_message=error)
        return Response(
            response_type=_RESPONSE_TYPE[first.request_type],
            tensor_names=[name],
            tensor_type=first.tensor_type,
            tensor_sizes=[first.num_elements],
            devices=sorted({r.device for r in reqs}),
            prescale_factor=first.prescale_factor,
            postscale_factor=first.postscale_factor,
        )

    # ------------------------------------------------------------------
    # fusion
    # ------------------------------------------------------------------

    _FUSIBLE = (ResponseType.ALLREDUCE, ResponseType.ADASUM)

    @staticmethod
    def _fusion_compatible(a: Response, b: Response) -> bool:
        return (a.response_type == b.response_type
                and a.tensor_type == b.tensor_type
                and a.devices == b.devices
                and a.prescale_factor == b.prescale_factor
                and a.postscale_factor == b.postscale_factor)

    def _fuse_responses(self, responses: List[Response]) -> List[Response]:
        """FIFO scan with look-ahead (``FuseResponses``): pop the front
        response, then sweep the remaining ones for compatible responses to
        pack under the threshold; incompatible ones seed their own buckets."""
        fused: List[Response] = []
        pending = list(responses)
        while pending:
            resp = pending.pop(0)
            if resp.response_type not in self._FUSIBLE:
                fused.append(resp)
                continue
            itemsize = resp.tensor_type.itemsize
            total = sum(resp.tensor_sizes) * itemsize
            rest: List[Response] = []
            for cand in pending:
                cand_bytes = sum(cand.tensor_sizes) * itemsize
                if (self._fusion_compatible(resp, cand)
                        and total + cand_bytes <= self.fusion_threshold):
                    resp.tensor_names.extend(cand.tensor_names)
                    resp.tensor_sizes.extend(cand.tensor_sizes)
                    total += cand_bytes
                else:
                    rest.append(cand)
            pending = rest
            fused.append(resp)
        return fused
