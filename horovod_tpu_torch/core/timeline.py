"""Chrome-tracing timeline: per-tensor lanes of negotiation and execution.

Counterpart of ``horovod_tpu/core/timeline.py`` (the reference's
``horovod/common/timeline.cc:1-509``): a catapult-format JSON trace in which
each tensor gets its own lane (tid), showing ``NEGOTIATE_<op>`` (how long
the ranks waited on each other, with each rank's ready tick, on rank 0's
trace) and then the operation, with the ``LC_*`` lifecycle spans nested in
it.  Records go through a ``SimpleQueue`` to a named writer thread, so the
background loop never blocks on disk.

Every rank writes its own trace with ``pid = rank`` (rank 0 at the
configured path, rank r at ``<path>.rank<r>``), every span carries its
negotiation **cycle id** (the lockstep round counter, the same on every
rank), and a ``clock_sync`` metadata record carries the trace's wall-clock
base.  ``horovod_tpu_torch/tools/trace_merge.py`` aligns the per-rank files
into one view and ``tools/critical_path.py`` attributes each step's time.

Each process estimates its wall-clock offset to the rendezvous server from
the server's ``GET /clock`` (:func:`estimate_server_clock_offset_ns`), and
``trace_merge`` aligns the files on it.  The control plane writes its own
spans on whatever timeline is active (``HOROVOD_TIMELINE_CONTROL_PLANE``,
default on): ``RVC_*`` around each store round trip, and in the launcher's
trace ``<path>.driver`` the driver's ``DRV_WAIT``, ``DRV_SPAWN`` and one
``CHURN_EVENT`` per epoch change; the server's own trace
(``HOROVOD_SERVER_TIMELINE``) holds its ``RV_*`` and ``JR_*`` spans.
``tools/control_path.py`` reads them.

Turned on by ``HOROVOD_TIMELINE`` (the launcher's ``--timeline-filename``)
or ``hvd.start_timeline()``; off by default, when every instrumented site
costs one module-attribute read.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, List, Optional

from ..common import env as env_mod

_WRITER_SENTINEL = None

#: Name of the per-trace metadata record trace_merge aligns clocks on.
CLOCK_SYNC_EVENT = "clock_sync"

#: Per-tensor lifecycle spans (submitted → negotiated → fused → wire →
#: unfused → callback) on every rank, read by ``tools/critical_path.py``.
LIFECYCLE_ENABLED = env_mod.get_bool(env_mod.HOROVOD_TIMELINE_LIFECYCLE, True)

#: Control-plane spans (``RV_*`` on the server's trace, ``RVC_*`` store
#: round trips, ``DRV_*`` and ``CHURN_EVENT`` on the driver's), read by
#: ``tools/control_path.py``.
CONTROL_PLANE_ENABLED = env_mod.get_bool(
    env_mod.HOROVOD_TIMELINE_CONTROL_PLANE, True)

#: The trace pids of the rendezvous server and the elastic driver: ranks
#: own the non-negative ones.
SERVER_TRACE_PID = -1
DRIVER_TRACE_PID = -2

#: The process's live Timeline, set by the constructor and cleared by
#: ``close()``: sites that cannot reach the runtime's state (the tensor
#: queue, the data plane) emit through the helpers below.
ACTIVE: Optional["Timeline"] = None


def lifecycle_begin(tensor_name: str, stage: str,
                    cycle: Optional[int] = None) -> None:
    tl = ACTIVE
    if tl is not None and LIFECYCLE_ENABLED:
        tl.lifecycle(tensor_name, stage, begin=True, cycle=cycle)


def lifecycle_end(tensor_name: str, stage: str) -> None:
    tl = ACTIVE
    if tl is not None and LIFECYCLE_ENABLED:
        tl.lifecycle(tensor_name, stage, begin=False)


def lifecycle_instant(tensor_name: str, stage: str,
                      cycle: Optional[int] = None) -> None:
    tl = ACTIVE
    if tl is not None and LIFECYCLE_ENABLED:
        tl.lifecycle_mark(tensor_name, stage, cycle=cycle)


def lifecycle_lanes(entries) -> List[str]:
    """The entries' tensor names when lifecycle spans would land
    somewhere, else an empty list: a fused op's sites then loop over
    nothing."""
    if ACTIVE is None or not LIFECYCLE_ENABLED:
        return []
    return [e.tensor_name for e in entries]


def lifecycle_span(names: List[str], stage: str, begin: bool) -> None:
    """A lifecycle begin or end on each lane in ``names`` (from
    :func:`lifecycle_lanes`)."""
    emit = lifecycle_begin if begin else lifecycle_end
    for name in names:
        emit(name, stage)


def control_active() -> bool:
    """True when a control-plane span emitted now would land somewhere."""
    return ACTIVE is not None and CONTROL_PLANE_ENABLED


def control_span_since(lane: str, name: str, t0_mono_ns: int,
                       **args) -> None:
    """A control-plane span on the active timeline covering
    ``[t0_mono_ns, now]``; nothing when no timeline is active."""
    tl = ACTIVE
    if tl is not None and CONTROL_PLANE_ENABLED:
        tl.span_since(lane, name, t0_mono_ns, args or None)


def control_instant(lane: str, name: str, **args) -> None:
    tl = ACTIVE
    if tl is not None and CONTROL_PLANE_ENABLED:
        tl.instant(lane, name, args or None)


def rank_trace_path(path: str, rank: int) -> str:
    """Rank 0 writes the configured path, rank r ``<path>.rank<r>``."""
    return path if rank == 0 else f"{path}.rank{rank}"


def estimate_server_clock_offset_ns(samples: int = 3) -> Optional[int]:
    """This host's wall-clock offset to the rendezvous server (``local -
    server``, ns) from its ``GET /clock``: of ``samples`` round trips, the
    one with the least round-trip time, its midpoint against the server's
    reading.  Every process measures against the same server, so two
    ranks' skew is the difference of their estimates.  None without a
    rendezvous server in the environment, or when it does not answer:
    ``trace_merge`` then assumes synced clocks."""
    import urllib.request

    addr = env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR)
    port = env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0)
    if not addr or not port:
        return None
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    best = None  # (rtt_ns, offset_ns)
    try:
        for _ in range(samples):
            t0 = time.time_ns()
            with opener.open(f"http://{addr}:{port}/clock",
                             timeout=2.0) as resp:
                server_ns = int(resp.read())
            t1 = time.time_ns()
            cand = (t1 - t0, (t0 + t1) // 2 - server_ns)
            if best is None or cand[0] < best[0]:
                best = cand
    except (OSError, ValueError):
        pass
    return None if best is None else best[1]


class Timeline:
    def __init__(self, path: str, mark_cycles: bool = False, rank: int = 0,
                 clock_offset_ns: Optional[int] = None,
                 activate: bool = True,
                 process_name: Optional[str] = None):
        self._mark_cycles = mark_cycles
        self._pid = rank
        self._cycle = 0
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._tids: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._start = time.monotonic_ns()
        # Sampled right after _start: ts=0 on this trace's axis is this
        # wall-clock instant (trace_merge's alignment anchor).
        self._wall_base_ns = time.time_ns()
        self._closed = False
        self._file = open(path, "w", buffering=1024 * 1024)
        self._file.write("[\n")
        self._first = True
        self._writer = threading.Thread(
            target=self._writer_loop, name="horovod-timeline", daemon=True)
        self._writer.start()
        self._emit({"name": "process_name", "ph": "M", "pid": self._pid,
                    "args": {"name": process_name
                             or f"horovod_tpu_torch rank {rank}"}})
        self._emit({"name": CLOCK_SYNC_EVENT, "ph": "M", "pid": self._pid,
                    "args": {"wall_base_ns": self._wall_base_ns,
                             "server_offset_ns": clock_offset_ns,
                             "rank": rank}})
        if activate:
            global ACTIVE
            ACTIVE = self

    # -- producers (any thread; never block on disk) -----------------------

    def _ts_us(self) -> float:
        return (time.monotonic_ns() - self._start) / 1e3

    def set_cycle(self, cycle: int) -> None:
        """The current negotiation cycle id; the background loop advances
        it each round.  Rounds are lockstep across ranks, so one id names
        one global round everywhere."""
        self._cycle = cycle

    def _tid(self, tensor_name: str) -> int:
        with self._lock:
            tid = self._tids.get(tensor_name)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[tensor_name] = tid
                self._emit({"name": "thread_name", "ph": "M",
                            "pid": self._pid, "tid": tid,
                            "args": {"name": tensor_name}})
        return tid

    def _emit(self, record: dict) -> None:
        if not self._closed:
            self._queue.put(record)

    def negotiate_start(self, tensor_name: str, op_name: str) -> None:
        self._emit({"name": f"NEGOTIATE_{op_name}", "ph": "B",
                    "pid": self._pid, "tid": self._tid(tensor_name),
                    "ts": self._ts_us(), "args": {"cycle": self._cycle}})

    def negotiate_rank_ready(self, tensor_name: str, rank: int) -> None:
        """One rank's readiness tick inside the negotiation span
        (reference ``NegotiateRankReady``, ``timeline.h:113``)."""
        self._emit({"name": str(rank), "ph": "i", "s": "t", "pid": self._pid,
                    "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def negotiate_end(self, tensor_name: str) -> None:
        self._emit({"name": "", "ph": "E", "pid": self._pid,
                    "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def op_start(self, response, entries) -> None:
        name = response.response_type.name
        ts = self._ts_us()
        # The cycle the response was negotiated in.
        cycle = getattr(response, "_cycle", self._cycle)
        for e in entries:
            self._emit({"name": name, "ph": "B", "pid": self._pid,
                        "tid": self._tid(e.tensor_name), "ts": ts,
                        "args": {"cycle": cycle}})

    def op_end(self, response, entries) -> None:
        ts = self._ts_us()
        for e in entries:
            self._emit({"name": "", "ph": "E", "pid": self._pid,
                        "tid": self._tid(e.tensor_name), "ts": ts})

    def activity(self, tensor_name: str, activity: str, begin: bool) -> None:
        """A nested activity marker (reference macro list
        ``common.h:31-62``)."""
        self._emit({"name": activity if begin else "",
                    "ph": "B" if begin else "E", "pid": self._pid,
                    "tid": self._tid(tensor_name), "ts": self._ts_us()})

    def lifecycle(self, tensor_name: str, stage: str, begin: bool,
                  cycle: Optional[int] = None) -> None:
        """A cycle-tagged lifecycle span on the tensor's lane (``LC_*``);
        the B record carries ``args.cycle``."""
        rec = {"name": stage if begin else "", "ph": "B" if begin else "E",
               "pid": self._pid, "tid": self._tid(tensor_name),
               "ts": self._ts_us()}
        if begin:
            rec["args"] = {"cycle": self._cycle if cycle is None else cycle}
        self._emit(rec)

    def lifecycle_mark(self, tensor_name: str, stage: str,
                       cycle: Optional[int] = None) -> None:
        """An instant lifecycle marker (``LC_NEGOTIATED`` with the cycle the
        response was agreed in)."""
        self._emit({"name": stage, "ph": "i", "s": "t", "pid": self._pid,
                    "tid": self._tid(tensor_name), "ts": self._ts_us(),
                    "args": {"cycle": self._cycle if cycle is None
                             else cycle}})

    def span_since(self, lane: str, name: str, t0_mono_ns: int,
                   args: Optional[dict] = None) -> None:
        """A complete ("X") span on a named lane covering
        ``[t0_mono_ns, now]``: atomic, so concurrent threads cannot
        mis-nest it."""
        b_us = (t0_mono_ns - self._start) / 1e3
        rec = {"name": name, "ph": "X", "pid": self._pid,
               "tid": self._tid(lane), "ts": b_us,
               "dur": self._ts_us() - b_us}
        if args:
            rec["args"] = dict(args)
        self._emit(rec)

    def instant(self, lane: str, name: str,
                args: Optional[dict] = None) -> None:
        rec = {"name": name, "ph": "i", "s": "t", "pid": self._pid,
               "tid": self._tid(lane), "ts": self._ts_us()}
        if args:
            rec["args"] = dict(args)
        self._emit(rec)

    def mark_cycle(self) -> None:
        if self._mark_cycles:
            self._emit({"name": "CYCLE", "ph": "i", "s": "g",
                        "pid": self._pid, "tid": 0, "ts": self._ts_us(),
                        "args": {"cycle": self._cycle}})

    # -- writer thread ------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            rec = self._queue.get()
            if rec is _WRITER_SENTINEL:
                break
            try:
                if not self._first:
                    self._file.write(",\n")
                self._first = False
                self._file.write(json.dumps(rec))
            except ValueError:  # the file was closed under the writer
                break

    def close(self, timeout: float = 10.0) -> None:
        """Stop taking records, drain the queue and close the array.  A
        writer still busy after ``timeout`` seconds keeps the file: a
        truncated trace with a valid prefix (which ``trace_merge``
        repairs) beats an interleaved corrupt one."""
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = None
        if self._closed:
            return
        self._closed = True
        self._queue.put(_WRITER_SENTINEL)
        self._writer.join(timeout=timeout)
        if self._writer.is_alive():
            return
        self._file.write("\n]\n")
        self._file.close()


# ---------------------------------------------------------------------------
# per-phase dispatch-chain accounting
# ---------------------------------------------------------------------------


class PhaseStats:
    """Always-on wall-time accumulator over the dispatch chain's phases:
    ``negotiate`` (the controller's round, busy cycles only), ``fuse``
    (the fused buffer, on the host plane its copy to the host), ``collective``
    (the cross-rank sum), ``unfuse`` (the copy back and the per-entry
    outputs), ``wait`` (a framework thread in ``synchronize``).  The
    aggregate companion of the trace: a few monotonic reads and one dict
    update per phase per response."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: Dict[str, List[float]] = {}

    def add(self, phase: str, seconds: float) -> None:
        with self._lock:
            slot = self._acc.get(phase)
            if slot is None:
                self._acc[phase] = [seconds, 1]
            else:
                slot[0] += seconds
                slot[1] += 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                phase: {
                    "total_ms": round(total * 1e3, 3),
                    "count": int(count),
                    "mean_ms": round(total / count * 1e3, 4),
                }
                for phase, (total, count) in self._acc.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()


#: The process's instance: the background loop, the host plane and the
#: framework threads' waits record into it.
phase_stats = PhaseStats()
