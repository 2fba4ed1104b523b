"""The process's metrics registry: counters, gauges and histograms.

The in-process part of ``horovod_tpu/core/metrics.py``: the same registry
API (``inc``, ``set_gauge``, ``observe``, ``get_counter``, ``get_gauge``,
``snapshot``, ``reset``), the same label flattening (``name{k="v"}``) and
the same fixed log2 histogram buckets.  The Prometheus rendering and the
HTTP scrape are not ported (ROADMAP.md A10).

The names the runtime writes (:data:`CATALOG`), all on rank 0 but the last:

- ``stalled_tensors`` (gauge) and ``stall_shutdowns_total`` (counter),
  from the stall inspector;
- ``straggler_lag_seconds`` (histogram), ``straggler_suspect`` (gauge) and
  ``straggler_flags_total`` (counter), from the straggler detector;
- ``fusion_reorders_total`` (counter), the cycles in which the readiness
  order changed the order of the responses;
- ``faults_injected_total`` (counter), each fault-injection clause fired
  (``common/faults.py``), on any rank.

The background thread records everything but the fault fires, which are
rare and come from the thread that hit the site; the registry takes no
lock, and a reader's ``snapshot`` copies each dict in one step.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

from ..common import env as env_mod

#: Upper bounds of the histogram buckets: 2^-20 s (about 1 us) to 2^6 s,
#: then an overflow bucket.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(2.0 ** k for k in range(-20, 7))

CATALOG: Dict[str, Tuple[str, str]] = {
    "stalled_tensors": (
        "gauge", "tensors past the stall age at the last stall check"),
    "stall_shutdowns_total": (
        "counter", "stall shutdowns fired"),
    "straggler_lag_seconds": (
        "histogram", "per busy cycle, how long a rank has kept a tensor "
                     "waiting after the median announcer, labeled rank="),
    "straggler_suspect": (
        "gauge", "the flagged rank with the worst readiness-lag EWMA, -1 "
                 "when none is flagged"),
    "straggler_flags_total": (
        "counter", "a rank's EWMA crossing the straggler threshold, "
                   "labeled rank="),
    "fusion_reorders_total": (
        "counter", "cycles whose readiness order differed from the order "
                   "of completion"),
    "faults_injected_total": (
        "counter", "fault-injection clauses fired (common/faults.py), on "
                   "the rank that fired them"),
}

def flat(name: str, **labels) -> str:
    """``name{k="v",...}`` with the keys sorted: the storage key."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        if '"' in v or "\n" in v:
            raise ValueError(f"label value {v!r} for {k} contains a "
                             "forbidden character")
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # flat name -> [per-bucket counts, sum, count]
        self._hists: Dict[str, List] = {}

    def inc(self, name: str, value: float = 1, **labels) -> None:
        key = flat(name, **labels)
        self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self._gauges[flat(name, **labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        key = flat(name, **labels)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = [[0] * (len(BUCKET_BOUNDS) + 1), 0.0, 0]
        h[0][bisect.bisect_left(BUCKET_BOUNDS, value)] += 1
        h[1] += value
        h[2] += 1

    def get_counter(self, name: str, **labels) -> float:
        return self._counters.get(flat(name, **labels), 0)

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(flat(name, **labels))

    def snapshot(self) -> dict:
        hists = {k: {"counts": list(h[0]), "sum": h[1], "count": h[2]}
                 for k, h in dict(self._hists).items()}
        return {
            "version": 1,
            "rank": env_mod.get_int(env_mod.HOROVOD_RANK, 0),
            "ts_unix_ns": time.time_ns(),
            "bucket_bounds": list(BUCKET_BOUNDS),
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": hists,
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()


registry = MetricsRegistry()


def inc(name: str, value: float = 1, **labels) -> None:
    registry.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    registry.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    registry.observe(name, value, **labels)
