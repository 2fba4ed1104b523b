"""Critical-path extraction over merged timeline traces.

Counterpart of ``horovod_tpu/tools/critical_path.py``.  Consumes the
output of ``tools/trace_merge.py`` (or raw per-rank trace files, merged on
the fly) and answers: **for each lockstep step (negotiation cycle), which
rank ended last, and where did that rank's, and every rank's, time go?**

Every span the runtime emits is cycle-tagged (``core/timeline.py``):
``NEGOTIATE_*`` spans on the coordinator with per-rank readiness instants,
and the ``LC_*`` lifecycle spans (submitted → negotiated → fused → wire →
unfused → callback) on every rank.  This tool rebuilds the B/E span trees
per (pid, tid), groups spans by their cycle id, and gives per step:

- the step window (first begin → last end across ranks) and its duration,
- the **critical rank**, the pid whose span ends the step,
- a per-rank attribution over the phases ``{negotiation_wait, fanin,
  fusion, wire, digest, reduce, dispatch}``, each the union of that
  rank's span intervals (union, not sum: a fused batch emits the same
  wire span on every member tensor's lane and must count once).

Phase mapping:

- ``NEGOTIATE_*`` → ``negotiation_wait``, charged to the **last-ready
  rank**: the span's duration up to its last readiness instant goes to
  that instant's rank.  Mask-path (cache-hit) negotiations emit no table
  spans and contribute nothing.
- ``FANIN_*`` → ``fanin`` (no emitter in the port yet: the tree fan-in is
  ROADMAP A9).
- ``LC_FUSE``/``LC_UNFUSE``/``MEMCPY*`` → ``fusion``; on the port's host
  plane ``LC_FUSE`` includes the copy to the host, which waits for the
  gradients.
- ``LC_WIRE_ALLGATHER``/``LC_WIRE_CROSS``/``LC_AG_STEP`` → ``wire``
- ``*DIGEST*`` → ``digest`` (no emitter: reads 0)
- ``LC_WIRE_REDUCE_SCATTER``/``LC_RS_STEP`` → ``reduce``; for the host
  plane's fp32, fp64 and integer sums (one opaque gloo call) this is the
  whole exchange.
- op spans (``ALLREDUCE``...) and ``LC_CALLBACK`` → ``dispatch``, minus
  the sub-intervals already attributed to fusion/wire/digest/reduce.

Usage::

    python -m horovod_tpu_torch.tools.critical_path merged_timeline.json
    python -m horovod_tpu_torch.tools.critical_path tl.json tl.json.rank1 \\
        --json cp.json --top 5
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .trace_merge import load_trace, merge

PHASES = ("negotiation_wait", "fanin", "fusion", "wire", "digest",
          "reduce", "dispatch")

_OP_SPANS = {"ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL", "ADASUM",
             "BARRIER", "JOIN", "LC_CALLBACK"}
_FUSION_SPANS = {"LC_FUSE", "LC_UNFUSE"}
_WIRE_SPANS = {"LC_WIRE_ALLGATHER", "LC_WIRE_CROSS", "LC_AG_STEP"}
_REDUCE_SPANS = {"LC_WIRE_REDUCE_SCATTER", "LC_RS_STEP"}


def _phase_of(name: str) -> Optional[str]:
    if name.startswith("FANIN_"):
        return "fanin"
    if name in _FUSION_SPANS or "MEMCPY" in name:
        return "fusion"
    if name in _WIRE_SPANS:
        return "wire"
    if "DIGEST" in name:
        return "digest"
    if name in _REDUCE_SPANS:
        return "reduce"
    if name in _OP_SPANS:
        return "dispatch"
    return None  # LC_SUBMITTED, NEGOTIATE_* (special-cased), unknown


class Span:
    __slots__ = ("name", "pid", "tid", "b", "e", "cycle", "instants")

    def __init__(self, name: str, pid, tid, b: float, cycle: Optional[int]):
        self.name = name
        self.pid = pid
        self.tid = tid
        self.b = b
        self.e: Optional[float] = None
        self.cycle = cycle
        # (ts, name) instants that fired while this span was innermost —
        # for NEGOTIATE spans these are the per-rank readiness ticks.
        self.instants: List[Tuple[float, str]] = []


def reconstruct(events: List[dict]) -> List[Span]:
    """Rebuild duration spans from B/E records per (pid, tid).  A span
    with no cycle tag inherits the nearest enclosing tagged span's cycle.
    Unclosed spans (crash-truncated trace) are closed at their lane's
    last timestamp."""
    lanes: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("ph") in ("B", "E", "i") and "ts" in e:
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    spans: List[Span] = []
    for (pid, tid), evs in lanes.items():
        evs.sort(key=lambda r: r["ts"])
        stack: List[Span] = []
        for r in evs:
            ph = r["ph"]
            if ph == "B":
                cycle = (r.get("args") or {}).get("cycle")
                if cycle is None and stack:
                    cycle = stack[-1].cycle
                s = Span(r.get("name", ""), pid, tid, r["ts"], cycle)
                stack.append(s)
                spans.append(s)
            elif ph == "E":
                if stack:
                    stack.pop().e = r["ts"]
            else:  # instant
                if stack:
                    stack[-1].instants.append((r["ts"], r.get("name", "")))
        if stack:
            last_ts = evs[-1]["ts"]
            for s in stack:
                s.e = last_ts
    return [s for s in spans if s.e is not None and s.e >= s.b]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [list(intervals[0])]
    for b, e in intervals[1:]:
        if b <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([b, e])
    return [(b, e) for b, e in out]


def _total(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - b for b, e in intervals)


def _subtract(base: List[Tuple[float, float]],
              cut: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """base \\ cut, both already unioned/sorted."""
    out: List[Tuple[float, float]] = []
    ci = 0
    for b, e in base:
        cur = b
        while ci < len(cut) and cut[ci][1] <= cur:
            ci += 1
        j = ci
        while j < len(cut) and cut[j][0] < e:
            cb, ce = cut[j]
            if cb > cur:
                out.append((cur, cb))
            cur = max(cur, ce)
            j += 1
        if cur < e:
            out.append((cur, e))
    return out


def analyze(events: List[dict]) -> dict:
    """Produce the per-step critical-path attribution document."""
    spans = reconstruct(events)
    by_cycle: Dict[int, List[Span]] = {}
    for s in spans:
        if s.cycle is not None:
            by_cycle.setdefault(s.cycle, []).append(s)

    steps = []
    totals: Dict[int, Dict[str, float]] = {}
    critical_counts: Dict[int, int] = {}
    covered_total = 0.0
    wall_total = 0.0
    for cycle in sorted(by_cycle):
        group = by_cycle[cycle]
        t0 = min(s.b for s in group)
        t1 = max(s.e for s in group)
        critical = max(group, key=lambda s: s.e)
        phases: Dict[int, Dict[str, float]] = {}
        # step-window intervals that got a phase attribution, any rank —
        # their union vs the wall clock is the step's coverage (the
        # control_path.py idiom: unattributed time is where the tool is
        # blind, and regressions there must be loud).
        covered_iv: List[Tuple[float, float]] = []

        def charge(rank, phase, us):
            if us <= 0:
                return
            phases.setdefault(rank, dict.fromkeys(PHASES, 0.0))[phase] += us
            totals.setdefault(rank, dict.fromkeys(PHASES, 0.0))[phase] += us

        # negotiation wait → the last-ready rank (the one everyone
        # actually waited for), read off the readiness instants the
        # coordinator stamps inside each NEGOTIATE span.
        for s in group:
            if not s.name.startswith("NEGOTIATE_"):
                continue
            ready = [(ts, int(n)) for ts, n in s.instants if n.isdigit()]
            if ready:
                ts_last, rank_last = max(ready)
                charge(rank_last, "negotiation_wait", ts_last - s.b)
                if ts_last > s.b:
                    covered_iv.append((s.b, ts_last))

        ranks = {s.pid for s in group}
        for rank in ranks:
            per_phase: Dict[str, List[Tuple[float, float]]] = \
                {p: [] for p in PHASES}
            for s in group:
                if s.pid != rank:
                    continue
                p = _phase_of(s.name)
                if p is not None:
                    per_phase[p].append((s.b, s.e))
            unions = {p: _union(iv) for p, iv in per_phase.items()}
            # dispatch = op-span time not already attributed elsewhere
            cut = _union([iv
                          for p in ("fanin", "fusion", "wire", "digest",
                                    "reduce")
                          for iv in unions[p]])
            unions["dispatch"] = _subtract(unions["dispatch"], cut)
            for p in ("fanin", "fusion", "wire", "digest", "reduce",
                      "dispatch"):
                charge(rank, p, _total(unions[p]))
                covered_iv.extend(unions[p])

        dominant = {"rank": None, "phase": None, "us": 0.0}
        for rank, d in phases.items():
            for p, us in d.items():
                if us > dominant["us"]:
                    dominant = {"rank": rank, "phase": p, "us": us}
        critical_counts[critical.pid] = \
            critical_counts.get(critical.pid, 0) + 1
        wall = t1 - t0
        cov_us = _total(_union(
            [(max(b, t0), min(e, t1)) for b, e in covered_iv if e > b]))
        cov_us = min(cov_us, wall)
        covered_total += cov_us
        wall_total += wall
        steps.append({
            "cycle": cycle,
            "t0_us": round(t0, 1),
            "duration_us": round(wall, 1),
            "critical_rank": critical.pid,
            "critical_span": critical.name,
            "dominant": {**dominant, "us": round(dominant["us"], 1)},
            "unattributed_us": round(wall - cov_us, 1),
            "coverage": round(cov_us / wall, 4) if wall > 0 else 1.0,
            "phases_us": {str(r): {p: round(us, 1) for p, us in d.items()}
                          for r, d in sorted(phases.items())},
        })

    return {
        "format": "hvd-critical-path-v1",
        "steps": steps,
        "ranks_seen": sorted({s.pid for s in spans if s.pid is not None}),
        "critical_step_counts": {str(r): n for r, n
                                 in sorted(critical_counts.items())},
        "totals_us": {str(r): {p: round(us, 1) for p, us in d.items()}
                      for r, d in sorted(totals.items())},
        "coverage": round(covered_total / wall_total, 4)
        if wall_total > 0 else 1.0,
    }


def render_text(doc: dict, top: int = 10) -> str:
    lines = []
    steps = doc["steps"]
    lines.append(f"critical-path: {len(steps)} step(s), "
                 f"ranks {doc['ranks_seen']}")
    if not steps:
        lines.append("no cycle-tagged spans found — was the run traced "
                     "with HOROVOD_TIMELINE (and lifecycle spans on)?")
        return "\n".join(lines)
    counts = doc["critical_step_counts"]
    worst_rank = max(counts, key=lambda r: counts[r])
    lines.append(f"critical rank by step count: rank {worst_rank} "
                 f"({counts[worst_rank]}/{len(steps)} steps)")
    if "coverage" in doc:
        lines.append(f"attribution coverage: {doc['coverage']:.1%} of "
                     "step wall time carries a phase")
    lines.append("")
    lines.append("aggregate attribution (ms, union of span time per "
                 "rank/phase):")
    hdr = f"  {'rank':>4} " + "".join(f"{p:>17}" for p in PHASES)
    lines.append(hdr)
    for r, d in doc["totals_us"].items():
        lines.append(f"  {r:>4} "
                     + "".join(f"{d[p] / 1e3:>17.3f}" for p in PHASES))
    lines.append("")
    slowest = sorted(steps, key=lambda s: -s["duration_us"])[:top]
    lines.append(f"slowest {len(slowest)} step(s):")
    lines.append(f"  {'cycle':>6} {'ms':>10} {'crit-rank':>9} "
                 f"{'dominant':>28}")
    for s in slowest:
        d = s["dominant"]
        dom = (f"rank {d['rank']} {d['phase']} "
               f"{d['us'] / 1e3:.3f}ms" if d["rank"] is not None else "-")
        lines.append(f"  {s['cycle']:>6} {s['duration_us'] / 1e3:>10.3f} "
                     f"{s['critical_rank']:>9} {dom:>28}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="critical-path",
        description="per-step critical-path attribution over "
                    "horovod_tpu_torch timeline traces (merged or per-rank)")
    ap.add_argument("inputs", nargs="+",
                    help="a merged trace, or per-rank trace files")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the full report as JSON")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest steps to list in the text report "
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
