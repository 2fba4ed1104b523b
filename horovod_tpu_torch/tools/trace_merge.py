"""Merge per-rank Chrome-trace timelines into one cross-rank view.

Counterpart of ``horovod_tpu/tools/trace_merge.py``.  Each rank writes its
own catapult JSON (``core/timeline.py``: ``pid = rank``, spans tagged with
the lockstep negotiation ``cycle`` id, and a ``clock_sync`` metadata record
carrying ``wall_base_ns``, the wall-clock instant of that trace's
``ts=0``, plus ``server_offset_ns``, the offset to the rendezvous server's
clock, from its ``GET /clock``).  This
tool rebases every event onto the common clock and concatenates, so one
Perfetto view shows every rank's NEGOTIATE/op lanes for the same
collective.

Usage::

    python -m horovod_tpu_torch.tools.trace_merge tl.json tl.json.rank1 \\
        -o merged.json

Alignment: a trace's event at local ``ts`` µs happened at server time
``wall_base_ns/1e3 + ts - server_offset_ns/1e3`` µs; the merged axis is
that, rebased to the earliest trace.  When a file predates clock_sync (or
the offset estimate failed), the merge still works but emits a warning
and falls back to concatenation without shifting — lanes remain correct
per rank, only cross-rank alignment degrades to assumed-synced clocks.

Truncated traces (a rank killed mid-write never wrote the closing ``]``)
are repaired on load: the valid prefix is kept, which is exactly the
writer's crash contract.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence, Tuple

# Shared with the emitter: a rename there must break here at import, not
# silently degrade every merge to the unaligned fallback.
from ..core.timeline import CLOCK_SYNC_EVENT


def load_trace(path: str) -> List[dict]:
    """Load one catapult JSON array, repairing a truncated tail (missing
    ``]``, trailing comma, or a half-written last record)."""
    with open(path) as f:
        text = f.read()
    try:
        events = json.loads(text)
    except ValueError:
        # Crash-truncated trace: drop the partial last record and close
        # the array — every complete record ends its line.
        lines = [ln.rstrip().rstrip(",") for ln in text.splitlines()
                 if ln.strip() and ln.strip() not in ("[", "]")]
        events = []
        for ln in lines:
            try:
                events.append(json.loads(ln))
            except ValueError:
                continue
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a catapult JSON event array")
    return events


def _clock_sync(events: List[dict]) -> Optional[Tuple[float, int]]:
    """(base_us_on_server_clock, rank) from the trace's clock_sync meta:
    the server-clock µs corresponding to this trace's ts=0."""
    for e in events:
        if e.get("name") == CLOCK_SYNC_EVENT and e.get("ph") == "M":
            args = e.get("args", {})
            wall = args.get("wall_base_ns")
            if wall is None:
                return None
            offset = args.get("server_offset_ns") or 0
            return (wall - offset) / 1e3, e.get("pid", args.get("rank", 0))
    return None


def merge(traces: List[List[dict]],
          warn=lambda msg: print(msg, file=sys.stderr)) -> List[dict]:
    """Merge event lists onto one time axis (see module docstring)."""
    syncs = [_clock_sync(t) for t in traces]
    align = all(s is not None for s in syncs) and bool(traces)
    if not align and traces:
        warn("trace_merge: clock_sync metadata missing from at least one "
             "trace; concatenating WITHOUT cross-rank clock alignment")
    t0 = min(s[0] for s in syncs) if align else 0.0
    merged: List[dict] = []
    seen_pids = set()
    for trace, sync in zip(traces, syncs):
        shift = (sync[0] - t0) if align else 0.0
        if sync is not None:
            if sync[1] in seen_pids:
                warn(f"trace_merge: duplicate pid {sync[1]} across input "
                     "traces; lanes will overlap")
            seen_pids.add(sync[1])
        for e in trace:
            if "ts" in e:
                e = dict(e)
                e["ts"] = e["ts"] + shift
            merged.append(e)
    merged.sort(key=lambda e: e.get("ts", -1))
    return merged


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace-merge",
        description="merge per-rank horovod_tpu_torch timeline traces into "
                    "one clock-aligned Chrome/Perfetto trace")
    ap.add_argument("inputs", nargs="+",
                    help="per-rank trace files (tl.json tl.json.rank1 ...)")
    ap.add_argument("-o", "--out", default="merged_timeline.json",
                    help="merged output path (default: %(default)s)")
    args = ap.parse_args(argv)

    traces = [load_trace(p) for p in args.inputs]
    merged = merge(traces)
    with open(args.out, "w") as f:
        json.dump(merged, f)
        f.write("\n")
    ranks = sorted({e.get("pid") for e in merged if "pid" in e})
    print(f"trace-merge: {len(args.inputs)} trace(s), {len(merged)} "
          f"events, pids {ranks} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
