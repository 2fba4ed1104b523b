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
4. the cycle's responses, oldest tensor first (``HOROVOD_FUSION_ORDER``),
   are fused under the fusion threshold (``FuseResponses``,
   ``controller.cc:859-998``) and broadcast;
5. every rank executes the ``ResponseList`` in the same order.

Steps 2 and 4 are the JAX package's star, carried by a control plane
(``transport/control.py``: collectives on the gloo control group).  A
shutdown requested on any rank travels up with its list and comes back in
the verdict, so every rank stops in the same cycle.

The response cache (``core/response_cache.py``, the reference's
``CoordinateCacheAndState``, ``controller.cc:826-851``), at size > 1
unless ``HOROVOD_CACHE_CAPACITY=0``: a tensor negotiated once is announced
afterwards as a bit of a mask.  A bit set in every active rank's mask is
ready, its response built from the cached template without tallying or
validation (``_mask_round``).  A cycle in which every rank sent bits only
and nothing else changed is answered with the agreed mask alone
(:class:`~.messages.MaskFrame`), from which every rank rebuilds the same
fused responses (``_responses_from_agreed_mask``).

Join (``controller.cc:1030-1053``): a JOIN request adds its rank to the
joined set, and a tensor is ready once its requesting ranks plus the joined
ones cover the world; the joined ranks contribute zeros to an allreduce
(``core/state.py``), while a broadcast, allgather or alltoall with joined
ranks is an ERROR.  The JOIN response goes out once every rank has joined.

The coordinator's guards, run every cycle after fusion:

- the straggler detector (``_update_stragglers``): per rank, an EWMA of
  how long it keeps tensors waiting after the median announcer; above
  ``HOROVOD_STRAGGLER_THRESHOLD_SECS`` the rank is flagged, and a
  :class:`DemotionPolicy` verdict is logged (no elastic driver acts on it
  yet);
- the stall inspector (``_check_stalls``, the reference's
  ``stall_inspector.cc``): a tensor waiting past
  ``HOROVOD_STALL_CHECK_TIME_SECONDS`` is named in a warning with its
  missing ranks and loses its cache entry; past
  ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` the job ends.  Rank 0 then sends
  an :class:`~.messages.AbortFrame` as the cycle's verdict, and every rank
  raises the same ``HorovodInternalError``.

Not ported yet (ROADMAP.md A1): the tree fan-out and the negotiation
fan-in; autotuning (A10).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Set, Tuple

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError
from ..common.logging_util import get_logger
from ..common.topology import ProcessTopology
from . import flight_recorder, metrics
from .messages import (
    AbortFrame,
    MaskFrame,
    Request,
    RequestList,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
    is_abort_frame,
    is_mask_frame,
)
from .response_cache import (
    CACHEABLE,
    CoordinatorCache,
    WorkerCacheMirror,
    cache_key,
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

#: The membership epoch a demotion verdict is scoped to: 0 until elastic
#: re-init (ROADMAP.md A6) advances it.
_EPOCH = 0


def _mask_bytes(mask: int) -> bytes:
    return mask.to_bytes((mask.bit_length() + 7) // 8, "little")


def _bits(mask: int):
    """The set bits of ``mask``, ascending."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


@dataclass
class _TableEntry:
    requests: List[Request] = field(default_factory=list)
    ranks: Set[int] = field(default_factory=set)
    # When the tensor was first requested, as a tally sequence number: the
    # coordinator emits a cycle's responses oldest first (the JAX package's
    # default "readiness" order, by ``first_seen``).
    first_seen: int = 0
    # The same moment on the monotonic clock: the stall inspector's age.
    since: float = 0.0
    # When half the active ranks had requested it: the straggler detector
    # measures the other ranks' lag from here, so one early rank does not
    # make every other rank look late.
    majority_seen: Optional[float] = None


class DemotionPolicy:
    """Chronic-straggler verdicts (``horovod_tpu/core/controller.py``
    ``DemotionPolicy``; no I/O, no clock).

    A rank whose readiness-lag EWMA stays above ``demote_secs`` for
    ``demote_cycles`` consecutive busy cycles gets a verdict:

    - a rank's streak resets as soon as its EWMA dips under the threshold;
    - when half or more of the active ranks are over it, the whole world
      is slow and nobody is demoted (all streaks reset), so at two ranks a
      verdict needs a third;
    - at most one verdict per membership epoch.
    """

    def __init__(self, demote_secs: float, demote_cycles: int):
        if demote_cycles < 1:
            raise ValueError(
                f"HOROVOD_STRAGGLER_DEMOTE_CYCLES={demote_cycles!r}: "
                "expected >= 1")
        self.demote_secs = demote_secs
        self.demote_cycles = demote_cycles
        self._streak: Dict[int, int] = {}
        self._demoted_epochs: Set[int] = set()

    @property
    def enabled(self) -> bool:
        return self.demote_secs > 0.0

    def observe(self, epoch: int, ewma: Dict[int, float],
                active: Set[int]) -> Optional[int]:
        """One busy cycle's EWMAs -> the rank to demote, or None."""
        if not self.enabled or not active:
            return None
        over = {r for r in active if ewma.get(r, 0.0) > self.demote_secs}
        if not over or 2 * len(over) >= len(active):
            self._streak.clear()
            return None
        for r in [r for r in self._streak if r not in over]:
            del self._streak[r]
        for r in over:
            self._streak[r] = self._streak.get(r, 0) + 1
        if epoch in self._demoted_epochs:
            return None
        chronic = [r for r in over if self._streak[r] >= self.demote_cycles]
        if not chronic:
            return None
        victim = max(chronic, key=lambda r: ewma.get(r, 0.0))
        self._demoted_epochs.add(epoch)
        self._streak.pop(victim, None)
        return victim


class Controller:
    def __init__(self, topology: ProcessTopology, control=None,
                 fusion_threshold_bytes: int = 64 * 1024 * 1024,
                 stall_warning_secs: float = 60.0,
                 stall_shutdown_secs: float = 0.0,
                 cache_capacity: int = 1024):
        """``control`` carries the rounds at size > 1: an object with
        ``gather(payload) -> [payload per rank] | None`` and
        ``broadcast(payload | None) -> payload``
        (:class:`~horovod_tpu_torch.transport.control.ControlPlane`).
        The straggler knobs and ``HOROVOD_FUSION_ORDER`` come from the
        environment, as in the JAX package."""
        if topology.size > 1 and control is None:
            raise HorovodInternalError(
                f"a controller of size {topology.size} needs a control plane")
        self.topo = topology
        self.control = control
        self.fusion_threshold = fusion_threshold_bytes
        self.stall_warning_secs = stall_warning_secs
        self.stall_shutdown_secs = stall_shutdown_secs
        self._message_table: Dict[str, _TableEntry] = {}
        self._tally = itertools.count()
        self._joined_ranks: Set[int] = set()
        # An allgather's bytes for the fusion threshold, by tensor name:
        # its response carries first dimensions only.
        self._payload_bytes: Dict[str, int] = {}
        self._last_stall_check = time.monotonic()
        # The cache: rank 0 assigns the bits, the workers mirror them.
        self.cache_enabled = cache_capacity > 0 and topology.size > 1
        self._cache = CoordinatorCache(cache_capacity) \
            if self.cache_enabled and topology.rank == 0 else None
        self._mirror = WorkerCacheMirror() \
            if self.cache_enabled and topology.rank != 0 else None
        self._cycle_assignments: List[Tuple[int, Request]] = []
        self._cycle_evictions: List[int] = []
        # Requests answered from the cache, and not; mask-only cycles that
        # completed work and idle ones; mask frames this worker sent; the
        # Requests this rank put on (or, rank 0, took off) the wire.
        self.cache_hit_count = 0
        self.cache_miss_count = 0
        self.fast_cycle_count = 0
        self.idle_fast_cycle_count = 0
        self.mask_only_sent_count = 0
        self.serialized_request_count = 0
        # Rank 0: each rank's announced bits not yet ready; when each
        # leftover bit was first announced, and when half the active ranks
        # had announced it.
        self._pending_masks: Dict[int, int] = {}
        self._mask_bit_since: Dict[int, float] = {}
        self._mask_bit_majority: Dict[int, float] = {}
        # Tensors completed by the stall inspector's conversion of bits to
        # tallies after the cycle's responses were built: next cycle's.
        self._stall_completed: List[str] = []
        order = env_mod.get_str(env_mod.HOROVOD_FUSION_ORDER,
                                "readiness").strip().lower()
        if order not in ("readiness", "arrival"):
            raise ValueError(
                f"HOROVOD_FUSION_ORDER={order!r}: expected readiness|arrival")
        self.fusion_order = order
        self.straggler_threshold = env_mod.get_float(
            env_mod.HOROVOD_STRAGGLER_THRESHOLD_SECS,
            env_mod.DEFAULT_STRAGGLER_THRESHOLD_SECS)
        alpha = env_mod.get_float(env_mod.HOROVOD_STRAGGLER_EWMA_ALPHA,
                                  env_mod.DEFAULT_STRAGGLER_EWMA_ALPHA)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(
                f"HOROVOD_STRAGGLER_EWMA_ALPHA={alpha!r}: expected (0, 1]")
        self.straggler_alpha = alpha
        self._straggler_ewma: Dict[int, float] = {}
        self._straggler_suspects: Set[int] = set()
        # False while every EWMA is zero and nothing lags: the per-cycle
        # update is then two checks.
        self._straggler_decaying = False
        # A new controller is a new world: a suspect gauge left by the last
        # one is cleared (a clean start writes nothing).
        if topology.rank == 0 and metrics.registry.get_gauge(
                "straggler_suspect") not in (None, -1):
            self._set_suspect_gauge()
        self.demotion = DemotionPolicy(
            env_mod.get_float(env_mod.HOROVOD_STRAGGLER_DEMOTE_SECS,
                              env_mod.DEFAULT_STRAGGLER_DEMOTE_SECS),
            env_mod.get_int(env_mod.HOROVOD_STRAGGLER_DEMOTE_CYCLES,
                            env_mod.DEFAULT_STRAGGLER_DEMOTE_CYCLES))

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
        self.control.gather(self._worker_payload(requests, should_shutdown))
        return self._apply_reply(self.control.broadcast(None))

    def _worker_payload(self, requests: List[Request],
                        should_shutdown: bool) -> bytes:
        """This worker's frame of the cycle: a :class:`MaskFrame` when every
        pending tensor hit the mirror (an idle cycle's mask is empty), else
        a ``RequestList`` of the misses with the hits as its mask."""
        hits: List[int] = []
        if self._mirror is not None:
            misses = []
            for req in requests:
                bit = self._mirror.hit(req)
                if bit is not None:
                    hits.append(bit)
                else:
                    misses.append(req)
            requests = misses
            self.cache_hit_count += len(hits)
            self.cache_miss_count += len(requests)
        mask = 0
        for bit in hits:
            mask |= 1 << bit
        if self._mirror is not None and not requests:
            self.mask_only_sent_count += 1
            return MaskFrame(mask=_mask_bytes(mask),
                             shutdown=should_shutdown).to_bytes()
        self.serialized_request_count += len(requests)
        return RequestList(requests=requests, shutdown=should_shutdown,
                           cache_mask=_mask_bytes(mask)).to_bytes()

    def _apply_reply(self, payload: bytes) -> ResponseList:
        """Decode rank 0's verdict: an abort raises its reason; a mask frame
        is rebuilt into responses from the mirrored templates; a
        ``ResponseList`` updates the mirror."""
        if is_abort_frame(payload):
            raise HorovodInternalError(AbortFrame.from_bytes(payload).reason)
        if is_mask_frame(payload):
            frame = MaskFrame.from_bytes(payload)
            if frame.mask_int:
                self.fast_cycle_count += 1
            else:
                self.idle_fast_cycle_count += 1
            return self._responses_from_agreed_mask(frame.mask_int,
                                                    frame.shutdown)
        return self._apply_response_list(ResponseList.from_bytes(payload))

    def _apply_response_list(self, rlist: ResponseList) -> ResponseList:
        if self._mirror is not None:
            self._mirror.apply(rlist.cache_assignments, rlist.evicted_bits)
        return rlist

    def _decode_worker_payload(self, payload: bytes):
        """(RequestList, was a mask frame) from either flavor."""
        if is_mask_frame(payload):
            frame = MaskFrame.from_bytes(payload)
            return RequestList(shutdown=frame.shutdown,
                               cache_mask=frame.mask), True
        rl = RequestList.from_bytes(payload)
        self.serialized_request_count += len(rl.requests)
        return rl, False

    def _coordinator_round(self, own_requests: List[Request],
                           should_shutdown: bool) -> ResponseList:
        # Rank 0's slot in the gather is empty: it tallies its own
        # requests below.
        payloads = self.control.gather(b"")
        try:
            verdict, rlist = self._coordinate(own_requests, payloads,
                                              should_shutdown)
        except Exception as e:
            # The workers wait in this cycle's broadcast: the verdict they
            # get is the abort, so that every rank raises the same error.
            reason = str(e) if isinstance(e, HorovodInternalError) \
                else f"{type(e).__name__}: {e}"
            self.control.broadcast(
                AbortFrame(origin_rank=0, reason=reason).to_bytes())
            raise
        self.control.broadcast(verdict)
        return rlist

    def _coordinate(self, own_requests: List[Request], payloads: List[bytes],
                    should_shutdown: bool) -> Tuple[bytes, ResponseList]:
        """Rank 0's cycle: tally or mask every rank's requests, build,
        order and fuse the responses, run the guards; returns the verdict's
        bytes and rank 0's own ``ResponseList``."""
        self._cycle_assignments = []
        self._cycle_evictions = []
        ready: List[str] = list(self._stall_completed)
        self._stall_completed.clear()
        pending = self._pending_masks
        own_all_cached = True
        for req in own_requests:
            bit = self._cache.lookup(cache_key(req)) \
                if self._cache is not None \
                and req.request_type in CACHEABLE else None
            if bit is not None:
                pending[0] = pending.get(0, 0) | (1 << bit)
                self.cache_hit_count += 1
            else:
                own_all_cached = False
                if self._increment(req):
                    ready.append(req.tensor_name)
        all_mask_frames = True
        for worker in range(1, self.topo.size):
            rl, was_mask = self._decode_worker_payload(payloads[worker])
            all_mask_frames = all_mask_frames and was_mask
            should_shutdown = should_shutdown or rl.shutdown
            if rl.cache_mask:
                pending[worker] = pending.get(worker, 0) | int.from_bytes(
                    rl.cache_mask, "little")
            for bit in rl.cache_hits:
                pending[worker] = pending.get(worker, 0) | (1 << bit)
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
        if self.fusion_order == "readiness" and len(ready) > 1:
            by_age = self._oldest_first(ready)
            if by_age != ready:
                metrics.inc("fusion_reorders_total")
                ready = by_age
        responses = [self._construct_response(name) for name in ready]
        responses = [r for r in responses if r is not None]
        mask_responses, ready_mask, mask_pure = self._mask_round(pending)
        responses.extend(mask_responses)
        responses = self._fuse_responses(responses)
        self._update_stragglers()
        self._check_stalls()
        if self._cache is not None:
            self._cache.tick()
        # Every rank's cycle was bits only, every response came from a
        # template, and nothing else has to reach the workers (assignments,
        # evictions, tallies, a joined rank, stall completions): the agreed
        # mask is the whole verdict.
        fast = (self.cache_enabled and own_all_cached and all_mask_frames
                and mask_pure and not ready and not self._joined_ranks
                and not self._cycle_assignments
                and not self._cycle_evictions and not self._stall_completed)
        if fast:
            if ready_mask:
                self.fast_cycle_count += 1
            else:
                self.idle_fast_cycle_count += 1
            return (MaskFrame(mask=_mask_bytes(ready_mask),
                              shutdown=should_shutdown).to_bytes(),
                    ResponseList(responses=responses,
                                 shutdown=should_shutdown))
        rlist = ResponseList(responses=responses, shutdown=should_shutdown,
                             cache_assignments=self._cycle_assignments,
                             evicted_bits=self._cycle_evictions)
        return rlist.to_bytes(), rlist

    def _oldest_first(self, ready: List[str]) -> List[str]:
        """The cycle's completed tensors by first request (stable), so the
        tensors that waited longest pack into the first fusion buckets;
        JOIN, which has no table entry, sorts first."""
        table = self._message_table
        return sorted(ready, key=lambda n: table[n].first_seen
                      if n in table else -1)

    # ------------------------------------------------------------------
    # the mask fast path
    # ------------------------------------------------------------------

    def _bit_template(self, bit: int) -> Optional[Request]:
        if self._cache is not None:
            return self._cache.rehydrate(bit, 0)
        if self._mirror is not None:
            return self._mirror.template(bit)
        return None

    def _responses_from_agreed_mask(self, mask: int,
                                    shutdown: bool) -> ResponseList:
        """A worker's half of the fast path: the templates of the agreed
        bits, ascending, fused as rank 0 fused them.  An agreed bit was
        announced by every rank, so a missing template means the mirror has
        diverged from rank 0's cache: that raises."""
        responses: List[Response] = []
        for bit in _bits(mask):
            tpl = self._bit_template(bit)
            if tpl is None:
                raise HorovodInternalError(
                    f"fast-path agreed cache bit {bit} has no local "
                    "template (cache mirror diverged from coordinator)")
            responses.append(self._response_from_template(tpl))
        return ResponseList(responses=self._fuse_responses(responses),
                            shutdown=shutdown)

    def _mask_round(self, pending: Dict[int, int]):
        """Resolve the announced bits: a bit set in every active rank's mask
        is ready and its response is the cached template's.  A bit evicted
        this cycle, or one whose tensor some other rank sent as a full
        ``Request`` (around an eviction), turns into table tallies so that
        neither side strands.

        Returns ``(responses, ready_mask, pure)``; ``pure`` is True when
        every response came straight from a live template in ready-bit
        order, the condition for answering with the mask alone."""
        if not pending:
            return [], 0, True
        pure = True
        responses: List[Response] = []
        for bit in self._cycle_evictions:
            low = 1 << bit
            if not any(m & low for m in pending.values()):
                continue
            pure = False
            tpl = self._bit_template(bit)
            completed = False
            for r, m in list(pending.items()):
                if m & low:
                    pending[r] = m & ~low
                    if tpl is not None:
                        completed |= self._increment(
                            replace(tpl, request_rank=r))
            self._mask_bit_since.pop(bit, None)
            self._mask_bit_majority.pop(bit, None)
            if completed:
                resp = self._construct_response(tpl.tensor_name)
                if resp is not None:
                    responses.append(resp)

        union = 0
        for m in pending.values():
            union |= m
        if union == 0:
            return responses, 0, pure
        ready_mask = None
        for r in range(self.topo.size):
            eff = -1 if r in self._joined_ranks else pending.get(r, 0)
            ready_mask = eff if ready_mask is None else (ready_mask & eff)
            if ready_mask == 0:
                break
        # With every rank joined the fold is -1: keep announced bits only.
        ready_mask = (ready_mask or 0) & union
        if ready_mask:
            for r, m in list(pending.items()):
                pending[r] = m & ~ready_mask
        for bit in _bits(ready_mask):
            self._mask_bit_since.pop(bit, None)
            self._mask_bit_majority.pop(bit, None)
            tpl = self._bit_template(bit)
            if tpl is None:
                log.error("ready unknown cache bit %d; dropping", bit)
                pure = False
                continue
            if tpl.request_type == RequestType.BROADCAST and \
                    self._joined_ranks:
                pure = False
                responses.append(Response(
                    response_type=ResponseType.ERROR,
                    tensor_names=[tpl.tensor_name],
                    error_message=f"broadcast for {tpl.tensor_name} cannot "
                                  "complete with joined ranks (Join "
                                  "supports allreduce only)."))
                continue
            responses.append(self._response_from_template(tpl))

        # Bits announced by some ranks only: start their stall clock, and
        # merge them with a full-Request tally of the same tensor.
        leftover = union & ~ready_mask
        if leftover:
            now = time.monotonic()
            for bit in _bits(leftover):
                low = 1 << bit
                self._mask_bit_since.setdefault(bit, now)
                if bit not in self._mask_bit_majority:
                    have = sum(1 for m in pending.values() if m & low)
                    if 2 * have >= self.topo.size - len(self._joined_ranks):
                        self._mask_bit_majority[bit] = now
                tpl = self._bit_template(bit)
                if tpl is None:
                    log.error("pending unknown cache bit %d; dropping", bit)
                    self._clear_bit(bit)
                    pure = False
                    continue
                if tpl.tensor_name in self._message_table:
                    pure = False
                    completed = False
                    for r, m in list(pending.items()):
                        if m & low:
                            pending[r] = m & ~low
                            completed |= self._increment(
                                replace(tpl, request_rank=r))
                    self._mask_bit_since.pop(bit, None)
                    self._mask_bit_majority.pop(bit, None)
                    if completed:
                        resp = self._construct_response(tpl.tensor_name)
                        if resp is not None:
                            responses.append(resp)
        return responses, ready_mask, pure

    def _clear_bit(self, bit: int) -> None:
        low = 1 << bit
        for r, m in list(self._pending_masks.items()):
            if m & low:
                self._pending_masks[r] = m & ~low
        self._mask_bit_since.pop(bit, None)
        self._mask_bit_majority.pop(bit, None)

    def _response_from_template(self, tpl: Request) -> Response:
        """What ``_construct_response`` builds for a validated single
        ALLREDUCE, ADASUM or BROADCAST, the cacheable operations."""
        return Response(
            response_type=_RESPONSE_TYPE[tpl.request_type],
            tensor_names=[tpl.tensor_name],
            tensor_type=tpl.tensor_type,
            tensor_sizes=[tpl.num_elements],
            devices=[tpl.device],
            prescale_factor=tpl.prescale_factor,
            postscale_factor=tpl.postscale_factor,
            last_joined_rank=min(self._joined_ranks)
            if self._joined_ranks else -1,
        )

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
                first_seen=next(self._tally), since=time.monotonic())
        if req.request_rank in entry.ranks:
            log.warning("rank %d re-submitted tensor %s before completion",
                        req.request_rank, req.tensor_name)
            return False
        entry.ranks.add(req.request_rank)
        entry.requests.append(req)
        active = self.topo.size - len(self._joined_ranks)
        if entry.majority_seen is None and 2 * len(entry.ranks) >= active:
            entry.majority_seen = time.monotonic()
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
        if self._cache is not None:
            bit, evicted = self._cache.maybe_insert(first)
            self._cycle_evictions.extend(evicted)
            if bit is not None:
                self._cycle_assignments.append((bit, first))
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

    # ------------------------------------------------------------------
    # straggler detection (rank 0)
    # ------------------------------------------------------------------

    def _update_stragglers(self) -> None:
        """Per-rank readiness-lag EWMAs from the tallies rank 0 keeps: a
        rank is behind by ``now - majority_seen`` on every incomplete tensor
        (table entry or announced bit) that half the active ranks have
        requested and it has not.  In steady state every tensor completes
        in its announcing cycle and this is two checks."""
        if not self._straggler_decaying and not self._mask_bit_majority \
                and not any(e.majority_seen is not None
                            for e in self._message_table.values()):
            return
        now = time.monotonic()
        behind: Dict[int, float] = {}
        active = set(range(self.topo.size)) - self._joined_ranks
        for entry in self._message_table.values():
            if entry.majority_seen is None:
                continue
            age = now - entry.majority_seen
            for r in active - entry.ranks:
                if age > behind.get(r, 0.0):
                    behind[r] = age
        for bit, since in self._mask_bit_majority.items():
            low = 1 << bit
            age = now - since
            for r in active:
                if not (self._pending_masks.get(r, 0) & low) \
                        and age > behind.get(r, 0.0):
                    behind[r] = age
        ewma = self._straggler_ewma
        thresh = self.straggler_threshold
        decaying = False
        for r in range(self.topo.size):
            lag = behind.get(r, 0.0)
            v = ewma.get(r, 0.0)
            v += self.straggler_alpha * (lag - v)
            ewma[r] = v
            decaying = decaying or v > 1e-9
            if lag > 0.0:
                metrics.observe("straggler_lag_seconds", lag, rank=str(r))
            if thresh <= 0.0:
                continue
            if v > thresh and r not in self._straggler_suspects:
                self._straggler_suspects.add(r)
                metrics.inc("straggler_flags_total", rank=str(r))
                flight_recorder.record(
                    "straggler", rank=r, lag_ewma=round(v, 6),
                    threshold=thresh)
                log.warning(
                    "straggler detected: rank %d readiness-lag EWMA %.3fs "
                    "exceeds HOROVOD_STRAGGLER_THRESHOLD_SECS=%.3fs "
                    "(it keeps completing tensors %0.3fs after the median "
                    "announcer)", r, v, thresh, lag)
                self._set_suspect_gauge()
            elif v < thresh / 2.0 and r in self._straggler_suspects:
                # Cleared at half the threshold, so that a rank near it
                # does not flap.
                self._straggler_suspects.discard(r)
                flight_recorder.record("straggler_cleared", rank=r,
                                       lag_ewma=round(v, 6))
                log.info("straggler cleared: rank %d readiness-lag EWMA "
                         "back to %.3fs", r, v)
                self._set_suspect_gauge()
        self._straggler_decaying = decaying or bool(self._straggler_suspects)
        if self.demotion.enabled:
            victim = self.demotion.observe(_EPOCH, ewma, active)
            if victim is not None:
                self._report_demotion(victim, ewma.get(victim, 0.0))

    def _report_demotion(self, victim: int, lag_ewma: float) -> None:
        """A chronic-straggler verdict, detector-only: a flight-recorder
        event and a log line.  There is no elastic driver to shed the rank
        (ROADMAP.md A6); the JAX package takes the same branch when it has
        no rendezvous store."""
        flight_recorder.record(
            "straggler_demotion", rank=victim, lag_ewma=round(lag_ewma, 6),
            threshold=self.demotion.demote_secs,
            cycles=self.demotion.demote_cycles)
        log.warning(
            "chronic straggler: rank %d readiness-lag EWMA %.3fs stayed "
            "over HOROVOD_STRAGGLER_DEMOTE_SECS=%.3fs for %d consecutive "
            "busy cycles — reporting for demotion", victim, lag_ewma,
            self.demotion.demote_secs, self.demotion.demote_cycles)
        log.warning("no rendezvous store reachable: demotion verdict "
                    "for rank %d is detector-only", victim)

    def _set_suspect_gauge(self) -> None:
        worst = max(self._straggler_suspects,
                    key=lambda r: self._straggler_ewma.get(r, 0.0)) \
            if self._straggler_suspects else -1
        metrics.set_gauge("straggler_suspect", worst)

    def _lag_suffix(self, missing: List[int]) -> str:
        """The stall warnings' laggard: the missing rank with the worst
        readiness-lag EWMA (empty when none has lagged)."""
        candidates = [r for r in missing
                      if self._straggler_ewma.get(r, 0.0) > 1e-9]
        if not candidates:
            return ""
        worst = max(candidates, key=lambda r: self._straggler_ewma[r])
        return (f"; slowest by readiness-lag EWMA: rank {worst} "
                f"({self._straggler_ewma[worst]:.3f}s)")

    # ------------------------------------------------------------------
    # stall inspection (rank 0; the reference's stall_inspector.cc)
    # ------------------------------------------------------------------

    def _check_stalls(self) -> None:
        """Warn about tensors some ranks have waited on past the warning
        time, and drop their cache entries; past the shutdown time, raise.
        The shutdown does not depend on the warning: either time set runs
        the check, every ``min`` of the two seconds."""
        warn, shut = self.stall_warning_secs, self.stall_shutdown_secs
        enabled = [t for t in (warn, shut) if t > 0]
        if not enabled:
            return
        now = time.monotonic()
        if now - self._last_stall_check < min(enabled):
            return
        self._last_stall_check = now
        stall_age = min(enabled)
        stalled = sum(1 for e in self._message_table.values()
                      if now - e.since > stall_age)
        stalled += sum(1 for since in self._mask_bit_since.values()
                       if now - since > stall_age)
        metrics.set_gauge("stalled_tensors", stalled)
        for name, entry in self._message_table.items():
            age = now - entry.since
            missing = sorted(set(range(self.topo.size))
                             - entry.ranks - self._joined_ranks)
            if shut > 0 and age > shut:
                metrics.inc("stall_shutdowns_total")
                raise HorovodInternalError(
                    f"stall shutdown: tensor {name} incomplete for "
                    f"{age:.0f}s (> {shut}s), missing ranks {missing}")
            if warn <= 0 or age <= warn:
                continue
            log.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for the "
                "remainder: %s stalled for %.0fs, missing ranks: %s%s",
                name, age, missing, self._lag_suffix(missing))
            # A stalled tensor renegotiates from scratch after recovery
            # (the reference's InvalidateStalledCachedTensors).
            if self._cache is not None:
                bit = self._cache.invalidate_name(name)
                if bit is not None:
                    self._cycle_evictions.append(bit)
        # A bit some ranks announced long ago that never reached the rest:
        # its announcements become table tallies and its entry goes.
        for bit, since in list(self._mask_bit_since.items()):
            age = now - since
            have = [r for r, m in self._pending_masks.items()
                    if m & (1 << bit)]
            missing = sorted(set(range(self.topo.size)) - set(have)
                             - self._joined_ranks)
            if shut > 0 and age > shut:
                tpl = self._bit_template(bit)
                name = tpl.tensor_name if tpl else f"<bit {bit}>"
                metrics.inc("stall_shutdowns_total")
                raise HorovodInternalError(
                    f"stall shutdown: cached tensor {name} incomplete for "
                    f"{age:.0f}s (> {shut}s), missing ranks {missing}")
            if warn <= 0 or age <= warn:
                continue
            tpl = self._bit_template(bit)
            if tpl is None:
                self._clear_bit(bit)
                continue
            log.warning(
                "cached tensor %s announced by ranks %s stalled for %.0fs, "
                "missing ranks: %s%s — invalidating its cache entry",
                tpl.tensor_name, have, age, missing,
                self._lag_suffix(missing))
            for r in have:
                self._pending_masks[r] &= ~(1 << bit)
                if self._increment(replace(tpl, request_rank=r)):
                    self._stall_completed.append(tpl.tensor_name)
            self._mask_bit_since.pop(bit, None)
            self._mask_bit_majority.pop(bit, None)
            evicted = self._cache.invalidate_name(tpl.tensor_name)
            if evicted is not None:
                self._cycle_evictions.append(evicted)
