"""Adasum's per-entry arithmetic over a fused pair of vectors.

Counterpart of ``_partial_triplets`` and ``_apply_combine``
(``horovod_tpu/backend/adasum.py:68-110``) and of the ``combine`` inside
``XlaAdasum`` (``horovod_tpu/backend/xla.py:365-379``).  A fused buffer
holds many entries (tensors) end to end; a *segment table* lists, for the
window ``[lo, hi)`` of it that a pair ``a``, ``b`` covers, each entry that
overlaps the window as ``(entry index, start, end)`` in window offsets
(``backend/adasum.py::_segment_bounds``).  Padding lies outside every
segment, so it never enters a norm.

- :func:`triplets` returns ``[entries, 3]`` fp64 rows of
  ``(a·b, ‖a‖², ‖b‖²)`` over each entry's segment (zeros for an entry
  outside the window); summed over the ranks that hold the other pieces of
  an entry, they are the whole entry's.
- :func:`combine` returns ``ca·a + cb·b`` on each segment, with
  ``ca = 1 − a·b / 2‖a‖²`` and ``cb = 1 − a·b / 2‖b‖²`` from the entry's
  triplet, or 1.0 where the squared norm is below ``sqrt(DBL_MIN)``
  (:data:`NORMSQ_EPS`; reference ``adasum.h:385-391``).  Elements outside
  every segment are 0.  The coefficients are rounded to the buffer's
  dtype, and each product and the sum are rounded once, as the JAX
  package's native combine does (``_native/native.cc`` ``hvd_combine_f32``).

``XlaAdasum`` takes 1.0 where its squared norm is not ``> 0``.  On fp32
inputs summed in fp64 the two rules pick the same entries: the least
nonzero fp32 magnitude is ``2^-149``, whose square ``2^-298`` is exact in
fp64 and far above ``NORMSQ_EPS = 2^-511``, and a sum of squares is at
least its largest term; so an fp32 entry's fp64 squared norm is 0 or at
least ``2^-298``, and ``>= NORMSQ_EPS`` holds exactly when ``> 0`` does.
(``XlaAdasum``'s own sums are fp32, where squares below ``2^-149``
underflow to 0: that is its precision, fault C4, not its rule.)

CUDA tensors take the kernels of ``csrc/adasum.cu`` (fp32 or fp64, 1-D,
contiguous, on one card), CPU tensors the plain versions beside them; a
CUDA tensor the kernels do not take raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

#: Kernel launches in this process, per wrapper.
LAUNCHES = {"adasum_triplets": 0, "adasum_combine": 0}
#: Elements per tile of the kernels (``kTile`` in ``csrc/adasum.cu``,
#: checked against it when the library loads).
TILE = 16384
#: Below this a squared norm counts as zero (``sqrt(DBL_MIN)``).
NORMSQ_EPS = math.sqrt(np.finfo(np.float64).tiny)

Segments = Sequence[Tuple[int, int, int]]


def coefficients(triplet, dtype: torch.dtype) -> Tuple[float, float]:
    """``(ca, cb)`` of one entry's ``(dot, ‖a‖², ‖b‖²)``, rounded to
    ``dtype``."""
    dot, aa, bb = (float(v) for v in triplet)
    ca = 1.0 - dot / (2.0 * aa) if aa >= NORMSQ_EPS else 1.0
    cb = 1.0 - dot / (2.0 * bb) if bb >= NORMSQ_EPS else 1.0
    if dtype == torch.float32:
        return float(np.float32(ca)), float(np.float32(cb))
    return ca, cb


def triplets_reference(a: torch.Tensor, b: torch.Tensor, segs: Segments,
                       num_entries: int) -> torch.Tensor:
    """Plain version of :func:`triplets`: fp64 dot products per segment."""
    out = torch.zeros(num_entries, 3, dtype=torch.float64, device=a.device)
    for idx, lo, hi in segs:
        av, bv = a[lo:hi].double(), b[lo:hi].double()
        out[idx, 0] += torch.dot(av, bv)
        out[idx, 1] += torch.dot(av, av)
        out[idx, 2] += torch.dot(bv, bv)
    return out


def combine_reference(a: torch.Tensor, b: torch.Tensor, segs: Segments,
                      trip: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`combine`."""
    out = torch.zeros_like(a)
    rows = trip.tolist()
    for idx, lo, hi in segs:
        ca, cb = coefficients(rows[idx], a.dtype)
        out[lo:hi] = a[lo:hi] * ca + b[lo:hi] * cb
    return out


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.library("adasum")
    lib.hvd_adasum_tile.argtypes = []
    lib.hvd_adasum_tile.restype = ctypes.c_longlong
    lib.hvd_adasum_normsq_eps.argtypes = []
    lib.hvd_adasum_normsq_eps.restype = ctypes.c_double
    if lib.hvd_adasum_tile() != TILE:
        raise RuntimeError(f"adasum: the CUDA source's tile is "
                           f"{lib.hvd_adasum_tile()} elements, the wrapper's "
                           f"{TILE}")
    if lib.hvd_adasum_normsq_eps() != NORMSQ_EPS:
        raise RuntimeError(f"adasum: the CUDA source's norm threshold is "
                           f"{lib.hvd_adasum_normsq_eps()!r}, the wrapper's "
                           f"{NORMSQ_EPS!r}")
    lib.hvd_adasum_triplets.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.hvd_adasum_triplets.restype = ctypes.c_int
    lib.hvd_adasum_combine.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.hvd_adasum_combine.restype = ctypes.c_int
    return lib


def tile_table(segs: Segments, num_entries: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernels' work list: ``tiles`` ``[3, n]`` int64 (entry, start,
    end of each tile of at most :data:`TILE` elements, the segments' tiles
    in order) and ``entry_ptr`` ``[num_entries + 1]``, where entry ``e``'s
    tiles are ``entry_ptr[e]:entry_ptr[e + 1]``.  Segments must come in
    entry order, one per entry at most."""
    seg = np.asarray(segs, dtype=np.int64).reshape(-1, 3)
    entry, lo, hi = seg[:, 0], seg[:, 1], seg[:, 2]
    if np.any(np.diff(entry) <= 0) or np.any(hi <= lo):
        raise ValueError(f"adasum: segments {list(segs)[:4]}... must be "
                         "non-empty and in increasing entry order")
    count = (hi - lo + TILE - 1) // TILE
    of = np.repeat(np.arange(len(seg)), count)
    first = np.repeat(np.cumsum(count) - count, count)
    start = lo[of] + (np.arange(len(of)) - first) * TILE
    tiles = np.stack([entry[of], start, np.minimum(start + TILE, hi[of])])
    per_entry = np.zeros(num_entries, dtype=np.int64)
    per_entry[entry] = count
    entry_ptr = np.concatenate([[0], np.cumsum(per_entry)]).astype(np.int64)
    return tiles, entry_ptr


def _check(segs: Segments, *tensors: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    a = tensors[0]
    if any(t.device != a.device for t in tensors) or a.device.type != "cuda":
        raise ValueError(
            f"adasum: tensors on {sorted({str(t.device) for t in tensors})}; "
            "the kernels take tensors on one CUDA device (CPU tensors take "
            "the plain version)")
    if a.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != a.dtype for t in tensors):
        raise TypeError(f"adasum: the kernels take one of fp32 or fp64, got "
                        f"{[t.dtype for t in tensors]}; widen 16-bit floats "
                        "first")
    if any(t.dim() != 1 or not t.is_contiguous() or t.numel() != a.numel()
           for t in tensors):
        raise ValueError(f"adasum: shapes {[tuple(t.shape) for t in tensors]}"
                         "; the kernels take contiguous 1-D tensors of one "
                         "length")
    if segs and max(hi for _, _, hi in segs) > a.numel():
        raise ValueError(f"adasum: a segment ends past the window's "
                         f"{a.numel()} elements")


@functools.lru_cache(maxsize=256)
def _cached_table(segs: Tuple[Tuple[int, int, int], ...], num_entries: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    tiles, entry_ptr = tile_table(segs, num_entries)
    return (torch.from_numpy(tiles).to(device),
            torch.from_numpy(entry_ptr).to(device))


def _device_table(segs: Segments, num_entries: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tile_table` on the card, kept per layout: a window's layout
    repeats every step, and a new one costs a copy that waits for the
    stream.  The current stream is recorded on the tables, so an evicted
    table is not reused while a launch still reads it."""
    tables = _cached_table(tuple(tuple(int(v) for v in seg) for seg in segs),
                           num_entries, torch.device(device))
    stream = torch.cuda.current_stream(device)
    for t in tables:
        t.record_stream(stream)
    return tables


def triplets(a: torch.Tensor, b: torch.Tensor, segs: Segments,
             num_entries: int) -> torch.Tensor:
    """``[num_entries, 3]`` fp64 ``(a·b, ‖a‖², ‖b‖²)`` per entry over its
    segment in ``segs``; CPU tensors take the plain version."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return triplets_reference(a, b, segs, num_entries)
    _check(segs, a, b)
    out = torch.zeros(num_entries, 3, dtype=torch.float64, device=a.device)
    if num_entries == 0:
        return out
    tiles, entry_ptr = _device_table(segs, num_entries, a.device)
    n_tiles = tiles.shape[1]
    partials = torch.empty(max(n_tiles, 1), 3, dtype=torch.float64,
                           device=a.device)
    with torch.cuda.device(a.device):
        err = _kernels().hvd_adasum_triplets(
            int(a.dtype == torch.float64), a.data_ptr(), b.data_ptr(),
            tiles.data_ptr(), n_tiles, entry_ptr.data_ptr(), num_entries,
            partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adasum: triplets launch failed with cudaError "
                           f"{err}")
    LAUNCHES["adasum_triplets"] += 1
    return out


def combine(a: torch.Tensor, b: torch.Tensor, segs: Segments,
            trip: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """``ca·a + cb·b`` on each segment with the coefficients of ``trip``
    (:func:`triplets`, summed over the ranks); 0 elsewhere.  On the card
    ``out`` may be ``a`` or ``b`` (then only the segments are written); CPU
    tensors take the plain version."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        result = combine_reference(a, b, segs, trip)
        if out is None:
            return result
        return out.copy_(result)
    if out is None:
        out = torch.zeros_like(a)
    _check(segs, a, b, out)
    if trip.dtype != torch.float64 or trip.device != a.device or \
            not trip.is_contiguous() or trip.dim() != 2 or trip.shape[1] != 3:
        raise ValueError(f"adasum: triplets {trip.dtype} "
                         f"{tuple(trip.shape)} on {trip.device}; the kernel "
                         "takes contiguous [entries, 3] fp64 on the card")
    if not segs:
        return out
    if max(e for e, _, _ in segs) >= trip.shape[0]:
        raise ValueError(f"adasum: a segment's entry is past the "
                         f"{trip.shape[0]} triplet rows")
    tiles, _ = _device_table(segs, trip.shape[0], a.device)
    with torch.cuda.device(a.device):
        err = _kernels().hvd_adasum_combine(
            int(a.dtype == torch.float64), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), tiles.data_ptr(), tiles.shape[1],
            trip.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adasum: combine launch failed with cudaError "
                           f"{err}")
    LAUNCHES["adasum_combine"] += 1
    return out

