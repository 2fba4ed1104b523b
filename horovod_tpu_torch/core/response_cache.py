"""Response cache: the steady-state negotiation fast path.

Counterpart of ``horovod_tpu/core/response_cache.py`` (the reference's
``response_cache.h:104-167`` and ``CoordinateCacheAndState``,
``controller.cc:826-851``): once a tensor has been negotiated, later cycles
announce it with one bit instead of a full ``Request``.  In the star,
rank 0 owns the cache:

- the **coordinator** gives a bit to each cacheable single-tensor response
  it builds and ships (bit, request template) assignments and evictions in
  the ``ResponseList``;
- **workers** mirror {key -> bit} and the template per bit; a pending
  request whose key they hold goes up as its bit;
- the coordinator turns a bit back into its template, so tallying and
  validation are unchanged; a bit set on every rank is ready without
  either;
- eviction is LRU at the coordinator (``HOROVOD_CACHE_CAPACITY``, default
  1024); an evicted bit is tombstoned for a few cycles, so that hits
  already on the wire still resolve, then recycled.

Cacheable operations: ALLREDUCE, ADASUM, BROADCAST, whose metadata is the
same on every rank.  An allgather's or alltoall's shape or splits differ
per rank and travel every cycle.  The key holds the device: a tensor on
the host and one on the card with the same name never share a bit.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

from .messages import Request, RequestType

CACHEABLE = (RequestType.ALLREDUCE, RequestType.ADASUM, RequestType.BROADCAST)
_TOMBSTONE_CYCLES = 4


def cache_key(req: Request) -> Tuple:
    return (req.tensor_name, int(req.request_type), int(req.tensor_type),
            tuple(req.tensor_shape), req.root_rank, req.device,
            req.prescale_factor, req.postscale_factor)


class CoordinatorCache:
    """Rank-0 side: bit assignment, LRU, tombstones."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, capacity)
        self._by_bit: "OrderedDict[int, Tuple[Tuple, Request]]" = OrderedDict()
        self._by_key: Dict[Tuple, int] = {}
        self._by_name: Dict[str, int] = {}
        self._tombstones: Dict[int, Tuple[Request, int]] = {}
        self._next_bit = 0
        # Recycled ids (evicted + tombstone expired): keeps the dense
        # bitmask wire format bounded by ~capacity bits instead of growing
        # with the total number of assignments ever made.  Safe because the
        # round trip is synchronous (a hit is consumed the same cycle it is
        # sent) and the controller converts lingering pending bits to table
        # tallies when their entry is evicted.
        self._free_bits: List[int] = []

    def lookup(self, key: Tuple) -> Optional[int]:
        bit = self._by_key.get(key)
        if bit is not None:
            self._by_bit.move_to_end(bit)
        return bit

    def rehydrate(self, bit: int, rank: int) -> Optional[Request]:
        """Request template for a hit bit (tombstoned bits still resolve)."""
        entry = self._by_bit.get(bit)
        if entry is not None:
            self._by_bit.move_to_end(bit)
            return replace(entry[1], request_rank=rank)
        tomb = self._tombstones.get(bit)
        if tomb is not None:
            return replace(tomb[0], request_rank=rank)
        return None

    def maybe_insert(self, req: Request) -> Tuple[Optional[int], List[int]]:
        """Cache an eligible request; returns (new_bit|None, evicted_bits).

        A same-name entry with a different key (tensor changed shape/dtype)
        is evicted first, like the reference invalidating stale entries."""
        if req.request_type not in CACHEABLE:
            return None, []
        evicted: List[int] = []
        key = cache_key(req)
        stale = self._by_name.get(req.tensor_name)
        if stale is not None and self._by_bit.get(stale, (key,))[0] != key:
            self._evict(stale)
            evicted.append(stale)
        if key in self._by_key:
            return None, evicted
        while len(self._by_bit) >= self.capacity:
            old_bit = next(iter(self._by_bit))
            self._evict(old_bit)
            evicted.append(old_bit)
        if self._free_bits:
            bit = self._free_bits.pop()
        else:
            bit = self._next_bit
            self._next_bit += 1
        template = replace(req, request_rank=0)
        self._by_bit[bit] = (key, template)
        self._by_key[key] = bit
        self._by_name[req.tensor_name] = bit
        return bit, evicted

    def invalidate_name(self, name: str) -> Optional[int]:
        """Evict a tensor's entry by name; returns the freed bit.

        Reference ``InvalidateStalledCachedTensors``: a stalled tensor's
        cached negotiation must not survive the stall — after recovery the
        tensor renegotiates from scratch."""
        bit = self._by_name.get(name)
        if bit is None:
            return None
        self._evict(bit)
        return bit

    def _evict(self, bit: int) -> None:
        entry = self._by_bit.pop(bit, None)
        if entry is None:
            return
        key, template = entry
        self._by_key.pop(key, None)
        if self._by_name.get(template.tensor_name) == bit:
            self._by_name.pop(template.tensor_name, None)
        self._tombstones[bit] = (template, _TOMBSTONE_CYCLES)

    def tick(self) -> None:
        """Age tombstones one cycle; expired ids return to the free pool."""
        dead = []
        for bit, (tpl, left) in self._tombstones.items():
            if left <= 1:
                dead.append(bit)
            else:
                self._tombstones[bit] = (tpl, left - 1)
        for bit in dead:
            self._tombstones.pop(bit, None)
            self._free_bits.append(bit)

    def __len__(self) -> int:
        return len(self._by_bit)


class WorkerCacheMirror:
    """Worker side: {key → bit} plus the full request template per bit,
    learned from ResponseList assignments.

    The template is what makes the zero-payload fast path possible: on a
    fully-cached cycle the coordinator answers with the agreed bitvector
    only, and each worker reconstructs the Responses locally from these
    templates (``controller._responses_from_agreed_mask``) instead of
    deserializing a broadcast ResponseList."""

    def __init__(self):
        self._by_key: Dict[Tuple, int] = {}
        self._by_bit: Dict[int, Tuple[Tuple, Request]] = {}

    def hit(self, req: Request) -> Optional[int]:
        return self._by_key.get(cache_key(req))

    def template(self, bit: int) -> Optional[Request]:
        """Request template for a live bit (None if unknown/evicted)."""
        entry = self._by_bit.get(bit)
        return entry[1] if entry is not None else None

    def apply(self, assignments: List[Tuple[int, Request]],
              evicted_bits: List[int]) -> None:
        # Assignments first: within one batch an eviction is always the
        # *later* event for its bit (a capacity eviction can hit a bit
        # assigned earlier in the same cycle).  Bit ids RECYCLE after their
        # tombstone expires, so an assignment overwriting a known bit must
        # also drop the stale key that previously mapped to it.
        for bit, template in assignments:
            key = cache_key(template)
            stale = self._by_bit.get(bit)
            if stale is not None and stale[0] != key:
                self._by_key.pop(stale[0], None)
            self._by_key[key] = bit
            self._by_bit[bit] = (key, template)
        for bit in evicted_bits:
            entry = self._by_bit.pop(bit, None)
            if entry is not None:
                self._by_key.pop(entry[0], None)

    def __len__(self) -> int:
        return len(self._by_key)
