"""Control-plane attribution over merged server, driver and worker traces.

The port's copy of ``horovod_tpu/tools/control_path.py``, the churn
counterpart of ``tools/critical_path.py``: where that tool says where a
training step's time went, this one says where an elastic change's time
went.  It reads the control plane's complete ("X") spans
(``core/timeline.py``):

- ``CHURN_EVENT``: one per epoch change, from the elastic driver
  (``elastic/driver.py``, tagged with its cause); each is an event window;
- ``RVC_SET/GET/KEYS/DELETE/BATCH``, the clients' round trips
  (``transport/store.py``), and ``RV_PUT/GET/...``, the server's request
  spans (``runner/rendezvous.py``; the server is ``trace_merge``'s clock
  base, so they merge unshifted);
- ``RV_BATCH``: the server applying one ``POST /batch`` (its own phase,
  ``batch_apply``: server compute, not wire time);
- ``RV_LOCK_WAIT``: waits for the store's lock;
- ``JR_FSYNC/JR_COMPACT/JR_REPLAY``: the journal's durability work
  (``transport/journal.py``);
- ``DRV_SPAWN``/``DRV_WAIT``: the driver's worker spawns and its loop's
  sleeps.

In each event window the phases are carved into disjoint intervals in
order (lock wait and fsync first, since they nest in the batch or round
trip that caused them, then batch apply, HTTP, spawn, the loop's wait), so
the per-phase times sum to the covered part of the window, and
``coverage`` says how much of the window's wall time they explain.

Usage::

    python -m horovod_tpu_torch.tools.control_path server.json \\
        tl.json.driver tl.json tl.json.rank1 [--json cp.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .critical_path import _subtract, _total, _union
from .trace_merge import load_trace, merge

EVENT_SPAN = "CHURN_EVENT"

#: Attribution order matters: each phase's intervals are clipped to the
#: event window and reduced by everything already attributed, so nested
#: costs (a lock wait inside an HTTP round-trip) count once, under the
#: most specific name.
PHASES = ("store_lock_wait", "journal_fsync", "batch_apply",
          "http_roundtrip", "respawn", "driver_tick_wait")

_JOURNAL_SPANS = {"JR_FSYNC", "JR_COMPACT", "JR_REPLAY"}


def _phase_of(name: str) -> Optional[str]:
    if name == "RV_LOCK_WAIT":
        return "store_lock_wait"
    if name in _JOURNAL_SPANS:
        return "journal_fsync"
    if name == "RV_BATCH":
        return "batch_apply"
    if name.startswith("RVC_") or name.startswith("RV_"):
        return "http_roundtrip"
    if name == "DRV_SPAWN":
        return "respawn"
    if name == "DRV_WAIT":
        return "driver_tick_wait"
    return None


def collect_spans(events: List[dict]) -> List[dict]:
    """Complete-event spans as ``{name, pid, b, e, args}`` dicts.  The
    control plane emits only "X" records; the workers' B/E spans belong to
    ``critical_path`` and are left out."""
    spans = []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        b = float(e["ts"])
        spans.append({"name": e.get("name", ""), "pid": e.get("pid"),
                      "b": b, "e": b + float(e.get("dur", 0.0)),
                      "args": e.get("args") or {}})
    return spans


def _clip(intervals: List[Tuple[float, float]], w0: float, w1: float
          ) -> List[Tuple[float, float]]:
    return [(max(b, w0), min(e, w1)) for b, e in intervals
            if e > w0 and b < w1]


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def analyze(events: List[dict]) -> dict:
    """Produce the per-churn-event attribution document."""
    spans = collect_spans(events)
    windows = sorted((s for s in spans if s["name"] == EVENT_SPAN),
                     key=lambda s: s["b"])
    by_phase: Dict[str, List[Tuple[float, float]]] = \
        {p: [] for p in PHASES}
    for s in spans:
        p = _phase_of(s["name"])
        if p is not None:
            by_phase[p].append((s["b"], s["e"]))
    unions = {p: _union(iv) for p, iv in by_phase.items()}

    out_events = []
    totals = dict.fromkeys(PHASES, 0.0)
    covered_total = 0.0
    wall_total = 0.0
    for i, w in enumerate(windows):
        w0, w1 = w["b"], w["e"]
        wall = w1 - w0
        covered: List[Tuple[float, float]] = []
        phases_us = {}
        for p in PHASES:
            exclusive = _subtract(_union(_clip(unions[p], w0, w1)), covered)
            phases_us[p] = _total(exclusive)
            totals[p] += phases_us[p]
            covered = _union(covered + exclusive)
        cov_us = _total(covered)
        covered_total += cov_us
        wall_total += wall
        out_events.append({
            "event": i,
            "cause": w["args"].get("cause"),
            "epoch": w["args"].get("epoch"),
            "pid": w["pid"],
            "t0_us": round(w0, 1),
            "duration_us": round(wall, 1),
            "phases_us": {p: round(v, 1) for p, v in phases_us.items()},
            "unattributed_us": round(wall - cov_us, 1),
            "coverage": round(cov_us / wall, 4) if wall > 0 else 1.0,
        })

    walls = sorted(e["duration_us"] for e in out_events)
    return {
        "format": "hvd-control-path-v1",
        "event_count": len(out_events),
        "events": out_events,
        "phase_totals_us": {p: round(v, 1) for p, v in totals.items()},
        "phase_share": {p: round(v / wall_total, 4) if wall_total else 0.0
                        for p, v in totals.items()},
        "wall_us": {"total": round(wall_total, 1),
                    "p50": round(_percentile(walls, 0.5), 1),
                    "p99": round(_percentile(walls, 0.99), 1)},
        "coverage": round(covered_total / wall_total, 4)
        if wall_total else 1.0,
        "pids_seen": sorted({s["pid"] for s in spans
                             if s["pid"] is not None}),
    }


def render_text(doc: dict, top: int = 10) -> str:
    lines = []
    n = doc["event_count"]
    lines.append(f"control-path: {n} churn event(s), "
                 f"pids {doc['pids_seen']}")
    if not n:
        lines.append("no CHURN_EVENT spans found — trace an elastic run "
                     "with HOROVOD_TIMELINE (+ HOROVOD_SERVER_TIMELINE "
                     "for the server side)")
        return "\n".join(lines)
    w = doc["wall_us"]
    lines.append(f"event wall: p50 {w['p50'] / 1e3:.3f}ms  "
                 f"p99 {w['p99'] / 1e3:.3f}ms  "
                 f"total {w['total'] / 1e3:.3f}ms  "
                 f"coverage {doc['coverage'] * 100:.1f}%")
    lines.append("")
    lines.append("aggregate attribution (disjoint carve, nested costs "
                 "count once under the most specific phase):")
    lines.append(f"  {'phase':>17} {'ms':>10} {'share':>7}")
    for p in PHASES:
        lines.append(f"  {p:>17} {doc['phase_totals_us'][p] / 1e3:>10.3f} "
                     f"{doc['phase_share'][p] * 100:>6.1f}%")
    unattr = w["total"] - sum(doc["phase_totals_us"].values())
    lines.append(f"  {'(unattributed)':>17} {unattr / 1e3:>10.3f} "
                 f"{(1 - doc['coverage']) * 100:>6.1f}%")
    lines.append("")
    slowest = sorted(doc["events"], key=lambda e: -e["duration_us"])[:top]
    lines.append(f"slowest {len(slowest)} event(s):")
    lines.append(f"  {'event':>6} {'ms':>10} {'cause':>14} {'cov':>6} "
                 f"{'dominant':>22}")
    for e in slowest:
        dom_p = max(PHASES, key=lambda p: e["phases_us"][p])
        dom = f"{dom_p} {e['phases_us'][dom_p] / 1e3:.3f}ms"
        lines.append(f"  {e['event']:>6} {e['duration_us'] / 1e3:>10.3f} "
                     f"{str(e['cause'] or '-'):>14} "
                     f"{e['coverage'] * 100:>5.1f}% {dom:>22}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.tools.control_path",
        description="per-churn-event control-plane attribution over "
                    "timeline traces (merged or separate "
                    "server/driver/worker files)")
    ap.add_argument("inputs", nargs="+",
                    help="a merged trace, or server/driver/worker traces")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the full report as JSON")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest events to list in the text report "
                         "(default: %(default)s)")
    args = ap.parse_args(argv)

    traces = [load_trace(p) for p in args.inputs]
    events = traces[0] if len(traces) == 1 else merge(traces)
    doc = analyze(events)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    print(render_text(doc, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
