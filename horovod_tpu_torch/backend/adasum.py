"""Adasum: the scale-insensitive reduction, on every plane.

Counterpart of ``horovod_tpu/backend/adasum.py`` (``AdasumAllreduce``,
``AdasumRingFallback``) and of ``XlaAdasum``
(``horovod_tpu/backend/xla.py:346-400, 909-947``); the reference's
``adasum/adasum.h:194-450``.  The operator merges two vectors ``a``, ``b``
entry by entry::

    a' = (1 - a·b / 2‖a‖²)·a + (1 - a·b / 2‖b‖²)·b

so equal directions average and orthogonal ones add; a coefficient is 1.0
where its squared norm is about zero, so ``adasum(0, g) == g`` (a joined
rank's zeros pass its peers' tensors through).  The per-entry arithmetic
is ``kernels/adasum.py``: the kernels of ``csrc/adasum.cu`` on CUDA
tensors, the plain versions on CPU tensors.

One class, :class:`Adasum`, built per plane by ``core/state.py::register_ops``
like the other collectives:

- ``LOCAL``, size 1: ``prescale·postscale`` into each output (JAX
  ``AdasumAllreduce.execute`` at size 1).
- ``PLANE_NCCL``, the device plane, at a power-of-two size with the tensors
  on the card (``XlaAdasum``'s algorithm): the entries fused, widened and
  prescaled, with no padding; log2(P) rounds, each exchanging the whole
  vector with rank ``r XOR 2^k`` by send/recv on the NCCL group and then
  combining, ``a`` the lower subgroup's vector and ``b`` the upper's; then
  postscale and unfuse.  Any other response falls through to the host
  plane's op, as the JAX chain falls through to the host backends.
- ``PLANE_HOST``, the host plane, at a power-of-two size
  (``AdasumAllreduce``'s vector-halving distance-doubling, VHDD): the fused
  buffer is zero-padded to a multiple of the size, the padding outside
  every entry's segment; at distance d = 1, 2, 4, ... each rank swaps half
  of its window with rank ``r XOR d`` by gloo send/recv on the control
  group (CUDA buffers staged through the host), forms the per-entry
  triplets of its kept half, sums them over the 2·d ranks that hold the
  other pieces of the pair by recursive doubling (so an entry cut by a
  window boundary gets one set of coefficients), and combines; the halves
  are then gathered back in reverse, postscaled and unfused.
- ``PLANE_HOST`` at any other size: the average (gloo's sum with the
  postscale divided by the size), with one warning per process, as
  ``AdasumRingFallback`` does; the reference refuses such sizes.

16-bit floats widen to fp32 in the fused buffer and round once at the
unfuse; the triplets are fp64 on every plane (the JAX device plane's are
fp32, fault C4 of ROADMAP.md).
"""

from __future__ import annotations

import copy
from typing import List, Tuple

import torch

from ..common.env import PLANE_NCCL
from ..common.logging_util import get_logger
from ..core.messages import Response
from ..core.tensor_queue import TensorTableEntry
from ..kernels import adasum as kernels
from .cuda import Allreduce, fuse, unfuse

log = get_logger("horovod_tpu_torch.backend.adasum")


def _segment_bounds(sizes: List[int], lo: int,
                    hi: int) -> List[Tuple[int, int, int]]:
    """(entry index, start, end) of every entry overlapping the ``[lo,
    hi)`` window of the fused buffer, in window offsets.  Padding (beyond
    the last entry) belongs to no segment."""
    bounds = []
    off = 0
    for idx, n in enumerate(sizes):
        t_lo, t_hi = max(off, lo), min(off + n, hi)
        if t_lo < t_hi:
            bounds.append((idx, t_lo - lo, t_hi - lo))
        off += n
    return bounds


def is_power_of_two(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


class Adasum(Allreduce):
    """The ADASUM response's op on one plane (module docstring)."""

    KIND = "adasum"
    #: Set once the averaging fallback has warned in this process.
    _warned = False

    def enabled(self, response: Response,
                entries: List[TensorTableEntry]) -> bool:
        if self.plane == PLANE_NCCL and not is_power_of_two(self.topo.size):
            return False
        return super().enabled(response, entries)

    def _run(self, response, entries, device):
        if self.group is None:
            super()._run(response, entries, device)
        elif self.plane == PLANE_NCCL:
            self._rounds(response, entries)
        elif is_power_of_two(self.topo.size):
            self._vhdd(response, entries)
        else:
            self._average(response, entries, device)

    # -- the device plane: XlaAdasum's whole-vector rounds ----------------

    def _rounds(self, response: Response,
                entries: List[TensorTableEntry]) -> None:
        fused = fuse(entries, response.prescale_factor)
        segs = _segment_bounds([e.tensor.numel() for e in entries], 0,
                               fused.numel())
        rank = self.topo.rank
        other = torch.empty_like(fused)
        distance = 1
        while distance < self.topo.size:
            self._ordered_exchange(fused, other, rank ^ distance)
            a, b = (fused, other) if rank & distance == 0 else (other, fused)
            kernels.combine(a, b, segs,
                            kernels.triplets(a, b, segs, len(entries)),
                            out=fused)
            distance <<= 1
        unfuse(fused, entries, response.postscale_factor)

    def _ordered_exchange(self, send: torch.Tensor, recv: torch.Tensor,
                          peer: int) -> None:
        """Swap ``send`` for the peer's into ``recv``: the lower rank sends
        first, so NCCL's blocking send to a peer that is itself sending
        cannot deadlock on a large buffer."""
        if self.topo.rank < peer:
            self.group.send([send], peer, 0).wait()
            self.group.recv([recv], peer, 0).wait()
        else:
            self.group.recv([recv], peer, 0).wait()
            self.group.send([send], peer, 0).wait()

    # -- the host plane: AdasumAllreduce's VHDD ---------------------------

    def _swap(self, send: torch.Tensor, peer: int) -> torch.Tensor:
        """``send`` to ``peer``, and the peer's tensor of the same shape
        back on ``send``'s device, through host buffers; both posted
        before either is waited on."""
        out = send.to("cpu")     # a CUDA buffer: waits for the op's stream
        got = torch.empty_like(out)
        sent = self.group.send([out], peer, 0)
        received = self.group.recv([got], peer, 0)
        sent.wait()
        received.wait()
        return got.to(send.device)

    def _sum_triplets(self, trip: torch.Tensor,
                      distance: int) -> torch.Tensor:
        """The triplets summed over the 2·``distance`` ranks holding pieces
        of the current pair: recursive doubling over XOR distances 1 ..
        ``distance`` (reference ``SumAllreduceWithComm``, ``adasum.h:368``).
        Every rank adds the same two operands at each step, so all hold the
        same bits."""
        total = trip.to("cpu")
        j = 1
        while j <= distance:
            total = total + self._swap(total, self.topo.rank ^ j)
            j <<= 1
        return total.to(trip.device)

    def _vhdd(self, response: Response,
              entries: List[TensorTableEntry]) -> None:
        size, rank = self.topo.size, self.topo.rank
        fused = fuse(entries, response.prescale_factor)
        sizes = [e.tensor.numel() for e in entries]
        real_n = fused.numel()
        if real_n % size:
            fused = torch.cat([fused, fused.new_zeros(size - real_n % size)])
        lo, hi = 0, fused.numel()
        halves: List[Tuple[int, bool]] = []   # (distance, kept the upper)
        distance = 1
        while distance < size:
            peer = rank ^ distance
            mid = lo + (hi - lo) // 2
            keep_upper = rank & distance != 0
            send_lo, send_hi, keep_lo, keep_hi = (lo, mid, mid, hi) \
                if keep_upper else (mid, hi, lo, mid)
            kept = fused[keep_lo:keep_hi]
            peer_half = self._swap(fused[send_lo:send_hi], peer)
            # Every rank of the reduction group agrees that ``a`` is the
            # lower subgroup's vector.
            a, b = (peer_half, kept) if keep_upper else (kept, peer_half)
            segs = _segment_bounds(sizes, keep_lo, keep_hi)
            trip = self._sum_triplets(
                kernels.triplets(a, b, segs, len(entries)), distance)
            kernels.combine(a, b, segs, trip, out=kept)
            halves.append((distance, keep_upper))
            lo, hi = keep_lo, keep_hi
            distance <<= 1
        for distance, keep_upper in reversed(halves):
            span = hi - lo
            other_lo = lo - span if keep_upper else hi
            fused[other_lo:other_lo + span] = self._swap(
                fused[lo:hi], rank ^ distance)
            lo, hi = min(lo, other_lo), max(hi, other_lo + span)
        unfuse(fused[:real_n], entries, response.postscale_factor)

    # -- the host plane at any other size ---------------------------------

    def _average(self, response: Response, entries: List[TensorTableEntry],
                 device: torch.device) -> None:
        if not Adasum._warned:
            Adasum._warned = True
            log.warning(
                "Adasum VHDD requires a power-of-two world size (have %d); "
                "falling back to ring-allreduce AVERAGE, which approximates "
                "Adasum only for well-correlated gradients", self.topo.size)
        scaled = copy.copy(response)
        scaled.postscale_factor = response.postscale_factor / self.topo.size
        super()._run(scaled, entries, device)
