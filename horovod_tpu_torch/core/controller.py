"""The coordination controller — agreement on which named tensors are ready
on every rank, every cycle.

Counterpart of ``horovod_tpu/core/controller.py`` (the reference's
``horovod/common/controller.cc:97-525``, ``ComputeResponseList``, with the
rank-0 coordinator protocol of ``controller.h:68-103``):

1. every rank drains its tensor queue into a ``RequestList``;
2. workers send their lists to rank 0, which tallies each tensor's ranks in
   the message table (``IncrementTensorCount``, ``controller.cc:1030-1053``);
3. a tensor requested by every rank becomes a validated ``Response``
   (``ConstructResponse``, ``controller.cc:547-824``): any disagreement in
   dtype, operation, scale factors or shape is an ERROR response that every
   rank delivers to the waiting callback;
4. the cycle's responses, oldest tensor first, are fused under the fusion
   threshold (``FuseResponses``, ``controller.cc:859-998``) and broadcast;
5. every rank executes the ``ResponseList`` in the same order.

Steps 2 and 4 are the JAX package's star, carried by a control plane
(``transport/control.py``: collectives on the gloo control group).  A
shutdown requested on any rank travels up with its list and comes back in
the verdict, so every rank stops in the same cycle.  Not ported yet
(ROADMAP.md A1): the response cache and its mask fast path, the tree
fan-out and negotiation fan-in, straggler detection and the stall
inspector, Join.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ..common.exceptions import HorovodInternalError
from ..common.logging_util import get_logger
from ..common.topology import ProcessTopology
from .messages import (
    Request,
    RequestList,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
)

log = get_logger("horovod_tpu_torch.controller")

#: The operations the port negotiates so far; both need one shape on
#: every rank.
_RESPONSE_TYPE = {
    RequestType.ALLREDUCE: ResponseType.ALLREDUCE,
    RequestType.ADASUM: ResponseType.ADASUM,
}


@dataclass
class _TableEntry:
    requests: List[Request] = field(default_factory=list)
    ranks: Set[int] = field(default_factory=set)
    # When the tensor was first requested, as a tally sequence number: the
    # coordinator emits a cycle's responses oldest first (the JAX package's
    # default "readiness" order, by ``first_seen``).
    first_seen: int = 0


class Controller:
    def __init__(self, topology: ProcessTopology, control=None,
                 fusion_threshold_bytes: int = 64 * 1024 * 1024,
                 stall_warning_secs: float = 60.0,
                 stall_shutdown_secs: float = 0.0):
        """``control`` carries the rounds at size > 1: an object with
        ``gather(payload) -> [payload per rank] | None`` and
        ``broadcast(payload | None) -> payload``
        (:class:`~horovod_tpu_torch.transport.control.ControlPlane`)."""
        if topology.size > 1 and control is None:
            raise HorovodInternalError(
                f"a controller of size {topology.size} needs a control plane")
        self.topo = topology
        self.control = control
        self.fusion_threshold = fusion_threshold_bytes
        # Read by the stall inspector, which is not ported yet.
        self.stall_warning_secs = stall_warning_secs
        self.stall_shutdown_secs = stall_shutdown_secs
        self._message_table: Dict[str, _TableEntry] = {}
        self._tally = itertools.count()

    # ------------------------------------------------------------------
    # the per-cycle negotiation round
    # ------------------------------------------------------------------

    def compute_response_list(self, requests: List[Request],
                              should_shutdown: bool = False) -> ResponseList:
        """One negotiation round over this cycle's requests.  At size > 1
        every rank calls this every cycle: the collectives keep the ranks
        in lockstep."""
        if self.topo.size == 1:
            return self._single_process_responses(requests, should_shutdown)
        if self.topo.rank == 0:
            return self._coordinator_round(requests, should_shutdown)
        return self._worker_round(requests, should_shutdown)

    def _single_process_responses(self, requests: List[Request],
                                  should_shutdown: bool) -> ResponseList:
        responses = []
        for req in requests:
            if self._increment(req):
                resp = self._construct_response(req.tensor_name)
                if resp is not None:
                    responses.append(resp)
        return ResponseList(responses=self._fuse_responses(responses),
                            shutdown=should_shutdown)

    def _worker_round(self, requests: List[Request],
                      should_shutdown: bool) -> ResponseList:
        self.control.gather(RequestList(requests=requests,
                                        shutdown=should_shutdown).to_bytes())
        return ResponseList.from_bytes(self.control.broadcast(None))

    def _coordinator_round(self, own_requests: List[Request],
                           should_shutdown: bool) -> ResponseList:
        ready = [req.tensor_name for req in own_requests
                 if self._increment(req)]
        # Rank 0 tallied its own requests above; its slot in the gather is
        # empty.
        payloads = self.control.gather(b"")
        for payload in payloads[1:]:
            rl = RequestList.from_bytes(payload)
            should_shutdown = should_shutdown or rl.shutdown
            for req in rl.requests:
                if self._increment(req):
                    ready.append(req.tensor_name)
        ready = self._oldest_first(ready)
        responses = [self._construct_response(name) for name in ready]
        rlist = ResponseList(
            responses=self._fuse_responses(
                [r for r in responses if r is not None]),
            shutdown=should_shutdown)
        self.control.broadcast(rlist.to_bytes())
        return rlist

    def _oldest_first(self, ready: List[str]) -> List[str]:
        """The cycle's completed tensors by first request (stable), so the
        tensors that waited longest pack into the first fusion buckets."""
        return sorted(ready, key=lambda n: self._message_table[n].first_seen)

    # ------------------------------------------------------------------
    # message table
    # ------------------------------------------------------------------

    def _increment(self, req: Request) -> bool:
        """Tally one rank's readiness; True when every rank has requested
        the tensor (``IncrementTensorCount``, ``controller.cc:1030-1053``)."""
        entry = self._message_table.get(req.tensor_name)
        if entry is None:
            entry = self._message_table[req.tensor_name] = _TableEntry(
                first_seen=next(self._tally))
        if req.request_rank in entry.ranks:
            log.warning("rank %d re-submitted tensor %s before completion",
                        req.request_rank, req.tensor_name)
            return False
        entry.ranks.add(req.request_rank)
        entry.requests.append(req)
        return len(entry.ranks) >= self.topo.size

    # ------------------------------------------------------------------
    # response construction & validation
    # ------------------------------------------------------------------

    def _construct_response(self, name: str) -> Optional[Response]:
        """Validate cross-rank consistency and emit the Response: the first
        disagreement in dtype, operation or scale factors (over every rank),
        then in shape, becomes an ERROR response.  The texts are the JAX
        package's."""
        if not self._message_table.get(name):
            return None
        reqs = self._message_table.pop(name).requests
        first = reqs[0]
        op = first.request_type
        error = None
        for req in reqs[1:]:
            if req.tensor_type != first.tensor_type:
                error = (f"Mismatched data types for {name}: rank "
                         f"{first.request_rank} sent {first.tensor_type.name}, "
                         f"rank {req.request_rank} sent {req.tensor_type.name}.")
                break
            if req.request_type != first.request_type:
                error = (f"Mismatched operations for {name}: ranks disagree on "
                         f"{first.request_type.name} vs {req.request_type.name}.")
                break
            if (req.prescale_factor != first.prescale_factor
                    or req.postscale_factor != first.postscale_factor):
                error = f"Mismatched pre/postscale factors for {name}."
                break
        if error is None and op not in _RESPONSE_TYPE:
            raise HorovodInternalError(
                f"{op.name} arrives with a later slice of the port "
                "(ROADMAP.md, queue A)")
        if error is None:
            for req in reqs[1:]:
                if req.tensor_shape != first.tensor_shape:
                    error = (f"Mismatched {op.name.lower()} tensor shapes for "
                             f"{name}: rank {first.request_rank} has "
                             f"{first.tensor_shape}, rank {req.request_rank} "
                             f"has {req.tensor_shape}.")
                    break
        if error is not None:
            return Response(response_type=ResponseType.ERROR,
                            tensor_names=[name], error_message=error)
        return Response(
            response_type=_RESPONSE_TYPE[op],
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
