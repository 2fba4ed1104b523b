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
the verdict, so every rank stops in the same cycle.

Join (``controller.cc:1030-1053``): a JOIN request adds its rank to the
joined set, and a tensor is ready once its requesting ranks plus the joined
ones cover the world; the joined ranks contribute zeros to an allreduce
(``core/state.py``), while a broadcast, allgather or alltoall with joined
ranks is an ERROR.  The JOIN response goes out once every rank has joined.

Not ported yet (ROADMAP.md A1): the response cache and its mask fast path,
the tree fan-out and negotiation fan-in, straggler detection and the stall
inspector.
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

JOIN_TENSOR_NAME = "__join__"
BARRIER_TENSOR_NAME = "__barrier__"

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
        self._joined_ranks: Set[int] = set()
        # An allgather's bytes for the fusion threshold, by tensor name:
        # its response carries first dimensions only.
        self._payload_bytes: Dict[str, int] = {}

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
        # A JOIN that lands after a tensor's last request from the ranks
        # still active must complete that tensor too.
        if self._joined_ranks:
            ready_set = set(ready)
            for name, entry in self._message_table.items():
                if name in ready_set:
                    continue
                needed = self.topo.size - len(self._joined_ranks - entry.ranks)
                if len(entry.ranks) >= needed:
                    ready.append(name)
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
        tensors that waited longest pack into the first fusion buckets;
        JOIN, which has no table entry, sorts first."""
        table = self._message_table
        return sorted(ready, key=lambda n: table[n].first_seen
                      if n in table else -1)

    # ------------------------------------------------------------------
    # message table
    # ------------------------------------------------------------------

    def _increment(self, req: Request) -> bool:
        """Tally one rank's readiness; True when the requesting ranks plus
        the joined ones cover the world (``IncrementTensorCount``,
        ``controller.cc:1030-1053``).  A JOIN completes when every rank has
        joined."""
        if req.request_type == RequestType.JOIN:
            self._joined_ranks.add(req.request_rank)
            return len(self._joined_ranks) == self.topo.size
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
        needed = self.topo.size - len(self._joined_ranks - entry.ranks)
        return len(entry.ranks) >= needed

    # ------------------------------------------------------------------
    # response construction & validation
    # ------------------------------------------------------------------

    def _construct_response(self, name: str) -> Optional[Response]:
        """Validate cross-rank consistency and emit the Response
        (``ConstructResponse``, ``controller.cc:547-824``): the first
        disagreement in dtype, operation or scale factors (over every rank),
        then in shape, root rank or splits, becomes an ERROR response, as
        does a broadcast, allgather or alltoall with joined ranks.  The
        texts are the JAX package's."""
        if name == JOIN_TENSOR_NAME or not self._message_table.get(name):
            if len(self._joined_ranks) == self.topo.size:
                self._joined_ranks.clear()
                return Response(response_type=ResponseType.JOIN,
                                tensor_names=[JOIN_TENSOR_NAME])
            return None
        entry = self._message_table.pop(name)
        reqs = entry.requests
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
        tensor_sizes: List[int] = []
        if error is None and op in (RequestType.ALLREDUCE, RequestType.ADASUM,
                                    RequestType.BROADCAST):
            for req in reqs[1:]:
                if req.tensor_shape != first.tensor_shape:
                    error = (f"Mismatched {op.name.lower()} tensor shapes for "
                             f"{name}: rank {first.request_rank} has "
                             f"{first.tensor_shape}, rank {req.request_rank} "
                             f"has {req.tensor_shape}.")
                    break
            tensor_sizes = [first.num_elements]
        if error is None and op == RequestType.BROADCAST:
            error = self._broadcast_error(name, reqs, entry)
        if error is None and op == RequestType.ALLGATHER:
            error = self._allgather_error(name, reqs)
            if error is None:
                tensor_sizes = [r.tensor_shape[0] if r.tensor_shape else 1
                                for r in sorted(reqs,
                                                key=lambda r: r.request_rank)]
        if error is None and op == RequestType.ALLTOALL:
            error = self._alltoall_error(name, reqs)
            if error is None:
                # The flattened N x N send-split matrix, row r = rank r's
                # splits; rank k receives column k.
                for req in sorted(reqs, key=lambda r: r.request_rank):
                    tensor_sizes.extend(req.splits)
        if error is not None:
            return Response(response_type=ResponseType.ERROR,
                            tensor_names=[name], error_message=error)
        if op == RequestType.ALLGATHER:
            dim0 = first.tensor_shape[0] if first.tensor_shape else 1
            inner_n = first.num_elements // max(1, dim0)
            self._payload_bytes[name] = (sum(tensor_sizes) * inner_n
                                         * first.tensor_type.itemsize)
        return Response(
            response_type=_RESPONSE_TYPE[op],
            tensor_names=[name],
            tensor_type=first.tensor_type,
            tensor_sizes=tensor_sizes,
            devices=sorted({r.device for r in reqs}),
            prescale_factor=first.prescale_factor,
            postscale_factor=first.postscale_factor,
            last_joined_rank=min(self._joined_ranks)
            if self._joined_ranks else -1,
        )

    def _broadcast_error(self, name: str, reqs: List[Request],
                         entry: _TableEntry) -> Optional[str]:
        first = reqs[0]
        for req in reqs[1:]:
            if req.root_rank != first.root_rank:
                return (f"Mismatched broadcast root ranks for {name}: "
                        f"{first.root_rank} vs {req.root_rank}.")
        # A joined rank has no tensor to receive into: Join supports
        # allreduce only.
        if len(entry.ranks) != self.topo.size:
            return (f"broadcast for {name} cannot complete with joined "
                    f"ranks (Join supports allreduce only).")
        return None

    def _allgather_error(self, name: str,
                         reqs: List[Request]) -> Optional[str]:
        """Every dimension but the first must agree on every rank."""
        first = reqs[0]
        for req in sorted(reqs, key=lambda r: r.request_rank):
            if len(req.tensor_shape) != len(first.tensor_shape) or \
                    req.tensor_shape[1:] != first.tensor_shape[1:]:
                return (f"Mismatched allgather tensor shapes for {name}: "
                        f"all dims but the first must match "
                        f"({first.tensor_shape} vs {req.tensor_shape}).")
        if len(reqs) != self.topo.size:
            return (f"allgather for {name} cannot complete with joined "
                    f"ranks (Join supports allreduce only, as in the "
                    f"reference JoinOp).")
        return None

    def _alltoall_error(self, name: str,
                        reqs: List[Request]) -> Optional[str]:
        """Trailing dimensions agree, and each rank's splits have one entry
        per rank and sum to its first dimension."""
        first = reqs[0]
        if len(reqs) != self.topo.size:
            return f"alltoall for {name} cannot complete with joined ranks."
        for req in sorted(reqs, key=lambda r: r.request_rank):
            if len(req.tensor_shape) != len(first.tensor_shape) \
                    or req.tensor_shape[1:] != first.tensor_shape[1:]:
                return (f"Mismatched alltoall tensor shapes for {name}: all "
                        f"dims but the first must match "
                        f"({first.tensor_shape} vs {req.tensor_shape}).")
            if len(req.splits) != self.topo.size:
                return (f"alltoall splits for {name} must have one entry "
                        f"per rank (rank {req.request_rank} sent "
                        f"{len(req.splits)}).")
            dim0 = req.tensor_shape[0] if req.tensor_shape else 0
            if sum(req.splits) != dim0:
                return (f"alltoall splits for {name} sum to "
                        f"{sum(req.splits)} but first dimension is {dim0} "
                        f"on rank {req.request_rank}.")
        return None

    # ------------------------------------------------------------------
    # fusion
    # ------------------------------------------------------------------

    _FUSIBLE = (ResponseType.ALLREDUCE, ResponseType.ADASUM,
                ResponseType.ALLGATHER)

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
        pack under the threshold; incompatible ones seed their own buckets.
        An allgather fuses whole per-rank blocks: each tensor adds ``size``
        first dimensions to ``tensor_sizes``."""
        payload = {r.tensor_names[0]: self._payload_bytes.pop(
            r.tensor_names[0], None) for r in responses}
        fused: List[Response] = []
        pending = list(responses)
        while pending:
            resp = pending.pop(0)
            if resp.response_type not in self._FUSIBLE:
                fused.append(resp)
                continue
            itemsize = resp.tensor_type.itemsize

            def payload_bytes(r: Response) -> int:
                n = payload[r.tensor_names[0]]
                return sum(r.tensor_sizes) * itemsize if n is None else n

            total = payload_bytes(resp)
            rest: List[Response] = []
            for cand in pending:
                cand_bytes = payload_bytes(cand)
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
