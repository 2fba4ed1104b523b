"""The port's timeline and its tools against the JAX package's.

(a) One seeded call sequence drives ``horovod_tpu.core.timeline.Timeline``
and the port's: the records must be equal once the times (``ts``, ``dur``,
the clock_sync's ``wall_base_ns``) are removed.
(b) ``rank_trace_path``, ``close()`` on a backlog and with a stuck writer,
a truncated trace that both ``trace_merge``s repair, and ``phase_stats``
snapshots, each against the JAX function.
(c) The port's ``trace_merge`` and ``critical_path`` and the JAX ones on the
same files give the same merged JSON, the same ``--json`` report and the
same text, on synthetic traces and on the np=2 job's traces of (d).
(d) One np=2 job of the port through its launcher with
``--timeline-filename`` and one np=2 job of the JAX package on its host
plane (``backend/cpu_ring.py``), both running one body: 3 steps of two bf16
and two fp32 allreduces, a barrier after each.  The bf16 lanes carry the
JAX ring's ``LC_*`` sequence; the fp32 lanes differ only as the port's
gloo sum documents (one ``LC_WIRE_REDUCE_SCATTER``, no
``LC_WIRE_ALLGATHER`` and no per-hop spans); rank 0 has the
``NEGOTIATE_ALLREDUCE`` spans with both ranks' ticks; both ranks tag each
op with the same cycle.
(e) The knobs: ``HOROVOD_TIMELINE`` is honoured, ``HOROVOD_TIMELINE_
CONTROL_PLANE`` puts the rendezvous client's ``RVC_*`` spans on the active
timeline, and with no timeline there is no file and no writer thread;
``hvd.start_timeline``/``stop_timeline``.
"""

from __future__ import annotations

import io
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.core import timeline as jax_timeline
from horovod_tpu.tools import critical_path as jax_critical_path
from horovod_tpu.tools import trace_merge as jax_trace_merge
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.core import timeline
from horovod_tpu_torch.core.state import global_state
from horovod_tpu_torch.tools import critical_path, trace_merge

from .helpers import run_distributed
from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
SIZE = 2
STEPS = 3

# Times: everything else of a record must match.
_TIMES = ("ts", "dur")


def _timeless(events):
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in _TIMES}
        if e.get("name") == timeline.CLOCK_SYNC_EVENT:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k != "wall_base_ns"}
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# (a) one call sequence, both Timelines
# ---------------------------------------------------------------------------

_LANES = ["grad.w", "grad.b", "bcast.param.x", "lane with spaces"]
_OPS = ["ALLREDUCE", "BROADCAST", "ALLGATHER", "ADASUM"]
_STAGES = ["LC_SUBMITTED", "LC_FUSE", "LC_WIRE_REDUCE_SCATTER",
           "LC_WIRE_ALLGATHER", "LC_UNFUSE", "LC_CALLBACK"]


def _call_sequence(seed: int, n: int = 300):
    """``n`` seeded calls covering every producer of a Timeline."""
    rng = random.Random(seed)
    calls = []
    for _ in range(n):
        kind = rng.choice(["negotiate", "ready", "negotiate_end", "op",
                           "activity", "lifecycle", "mark", "cycle",
                           "mark_cycle", "span", "instant"])
        lane = rng.choice(_LANES)
        if kind == "negotiate":
            calls.append(("negotiate_start", (lane, rng.choice(_OPS)), {}))
        elif kind == "ready":
            calls.append(("negotiate_rank_ready", (lane, rng.randrange(4)),
                          {}))
        elif kind == "negotiate_end":
            calls.append(("negotiate_end", (lane,), {}))
        elif kind == "op":
            names = rng.sample(_LANES, rng.randint(1, 3))
            response = SimpleNamespace(
                response_type=SimpleNamespace(name=rng.choice(_OPS)))
            if rng.random() < 0.7:
                response._cycle = rng.randrange(50)
            entries = [SimpleNamespace(tensor_name=x) for x in names]
            calls.append(("op_start", (response, entries), {}))
            calls.append(("op_end", (response, entries), {}))
        elif kind == "activity":
            calls.append(("activity", (lane, "MEMCPY_IN_FUSION_BUFFER",
                                       rng.random() < 0.5), {}))
        elif kind == "lifecycle":
            cycle = rng.choice([None, rng.randrange(50)])
            calls.append(("lifecycle", (lane, rng.choice(_STAGES),
                                        rng.random() < 0.5),
                          {"cycle": cycle}))
        elif kind == "mark":
            calls.append(("lifecycle_mark", (lane, "LC_NEGOTIATED"),
                          {"cycle": rng.choice([None, rng.randrange(50)])}))
        elif kind == "cycle":
            calls.append(("set_cycle", (rng.randrange(100),), {}))
        elif kind == "mark_cycle":
            calls.append(("mark_cycle", (), {}))
        elif kind == "span":
            args = rng.choice([None, {"epoch": rng.randrange(3)}])
            calls.append(("span_since", (f"ctl.{lane}", "RVC_GET",
                                         time.monotonic_ns() - 1000, args),
                          {}))
        else:
            calls.append(("instant", (f"ctl.{lane}", "EPOCH_TRANSITION",
                                      rng.choice([None, {"n": 1}])), {}))
    return calls


def _drive(cls, path: Path, calls, mark_cycles: bool, rank: int) -> list:
    tl = cls(str(path), mark_cycles=mark_cycles, rank=rank,
             clock_offset_ns=None, activate=False, process_name="worker")
    for method, args, kwargs in calls:
        getattr(tl, method)(*args, **kwargs)
    tl.close()
    return json.loads(path.read_text())


@pytest.mark.parametrize("seed,mark_cycles,rank", [
    (0, False, 0), (1, True, 0), (2, True, 3), (3, False, 1)])
def test_one_call_sequence_writes_the_jax_records(tmp_path, seed,
                                                  mark_cycles, rank):
    calls = _call_sequence(seed)
    ours = _drive(timeline.Timeline, tmp_path / "ours.json", calls,
                  mark_cycles, rank)
    theirs = _drive(jax_timeline.Timeline, tmp_path / "theirs.json", calls,
                    mark_cycles, rank)
    assert len(ours) > len(calls) // 2
    assert _timeless(ours) == _timeless(theirs)


def test_the_port_names_its_process(tmp_path):
    tl = timeline.Timeline(str(tmp_path / "t.json"), rank=2, activate=False)
    tl.close()
    first = json.loads((tmp_path / "t.json").read_text())[0]
    assert first == {"name": "process_name", "ph": "M", "pid": 2,
                     "args": {"name": "horovod_tpu_torch rank 2"}}


def test_activate_owns_the_module_slot_until_close(tmp_path):
    assert timeline.ACTIVE is None
    tl = timeline.Timeline(str(tmp_path / "t.json"))
    assert timeline.ACTIVE is tl
    timeline.lifecycle_begin("x", "LC_FUSE", cycle=7)
    timeline.lifecycle_end("x", "LC_FUSE")
    timeline.lifecycle_instant("x", "LC_NEGOTIATED")
    entry = SimpleNamespace(tensor_name="x")
    assert timeline.lifecycle_lanes([entry]) == ["x"]
    tl.close()
    assert timeline.ACTIVE is None and timeline.lifecycle_lanes([entry]) == []
    names = [(e["name"], e["ph"], e.get("args"))
             for e in json.loads((tmp_path / "t.json").read_text())
             if e["ph"] != "M"]
    assert names == [("LC_FUSE", "B", {"cycle": 7}), ("", "E", None),
                     ("LC_NEGOTIATED", "i", {"cycle": 0})]
    # After close, the helpers land nowhere.
    timeline.lifecycle_begin("x", "LC_FUSE")


# ---------------------------------------------------------------------------
# (b) rank paths, close, truncation, phase_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,rank", [("tl.json", 0), ("tl.json", 1),
                                       ("/a/b/trace", 7), ("x", 12)])
def test_rank_trace_path_is_the_jax_layout(path, rank):
    assert timeline.rank_trace_path(path, rank) == \
        jax_timeline.rank_trace_path(path, rank)


def test_the_clock_offset_is_none_without_a_clock_server(monkeypatch):
    monkeypatch.delenv(env_mod.HOROVOD_RENDEZVOUS_ADDR, raising=False)
    assert timeline.estimate_server_clock_offset_ns() is None
    assert jax_timeline.estimate_server_clock_offset_ns() is None


@pytest.mark.parametrize("cls", [timeline.Timeline, jax_timeline.Timeline],
                         ids=["port", "jax"])
def test_close_drains_a_backlog(tmp_path, cls):
    tl = cls(str(tmp_path / "t.json"), activate=False)
    for i in range(20000):
        tl.instant(f"lane{i % 13}", "TICK", {"i": i})
    tl.close()
    events = json.loads((tmp_path / "t.json").read_text())
    ticks = [e["args"]["i"] for e in events if e["name"] == "TICK"]
    assert ticks == list(range(20000))
    # Closed: later records are dropped, a second close is a no-op.
    tl.instant("late", "TICK")
    tl.close()


def test_close_with_a_stuck_writer_leaves_a_prefix_both_merges_repair(
        tmp_path):
    path = tmp_path / "t.json"
    tl = timeline.Timeline(str(path), activate=False)
    release = threading.Event()
    real_write = tl._file.write
    wrote = []

    def slow_write(text):
        wrote.append(text)
        if len(wrote) > 8:
            release.wait(5)
        return real_write(text)

    tl._file.write = slow_write
    for i in range(200):
        tl.instant("lane", "TICK", {"i": i})
    t0 = time.monotonic()
    tl.close(timeout=0.2)
    assert time.monotonic() - t0 < 3
    assert tl._writer.is_alive()
    tl._file.flush()
    text = path.read_text()
    with pytest.raises(ValueError):
        json.loads(text)
    ours = trace_merge.load_trace(str(path))
    theirs = jax_trace_merge.load_trace(str(path))
    assert ours == theirs and ours[0]["name"] == "process_name"
    release.set()
    tl._writer.join(5)


@pytest.mark.parametrize("cut", [0, 1, 7, 40, 200])
def test_a_truncated_trace_is_repaired_like_the_jax_merge(tmp_path, cut):
    path = tmp_path / "t.json"
    tl = timeline.Timeline(str(path), rank=1, activate=False)
    for method, args, kwargs in _call_sequence(5, 60):
        getattr(tl, method)(*args, **kwargs)
    tl.close()
    text = path.read_text()
    cut_path = tmp_path / "cut.json"
    cut_path.write_text(text[:len(text) - 2 - cut])
    ours = trace_merge.load_trace(str(cut_path))
    assert ours == jax_trace_merge.load_trace(str(cut_path))
    assert ours and ours == json.loads(text)[:len(ours)]


def test_phase_stats_snapshots_match_the_jax_ones():
    ours, theirs = timeline.PhaseStats(), jax_timeline.PhaseStats()
    rng = random.Random(4)
    for _ in range(500):
        phase = rng.choice(["negotiate", "fuse", "collective", "unfuse",
                            "wait"])
        seconds = rng.random() * 1e-2
        ours.add(phase, seconds)
        theirs.add(phase, seconds)
    assert ours.snapshot() == theirs.snapshot()
    ours.reset()
    theirs.reset()
    assert ours.snapshot() == theirs.snapshot() == {}


# ---------------------------------------------------------------------------
# (c) the tools on the same files
# ---------------------------------------------------------------------------

def _run_tool(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), err.getvalue()


def _tools_agree(tmp_path: Path, inputs) -> dict:
    """Both packages' trace_merge and critical_path on ``inputs``: the same
    merged JSON, report, text and warnings.  Returns the report."""
    results = {}
    for tag, merge_mod, cp_mod in (("port", trace_merge, critical_path),
                                   ("jax", jax_trace_merge,
                                    jax_critical_path)):
        merged = tmp_path / f"merged.{tag}.json"
        report = tmp_path / f"cp.{tag}.json"
        merge_out = _run_tool(merge_mod.main,
                              [*map(str, inputs), "-o", str(merged)])
        cp_out = _run_tool(cp_mod.main, [*map(str, inputs), "--json",
                                         str(report), "--top", "5"])
        cp_merged = _run_tool(cp_mod.main, [str(merged)])
        results[tag] = (merge_out, cp_out, cp_merged,
                        json.loads(merged.read_text()),
                        json.loads(report.read_text()))
    ours, theirs = results["port"], results["jax"]
    for a, b in zip(ours, theirs):
        if isinstance(a, tuple):
            # The output file's name is in trace-merge's line.
            assert a[0] == b[0] and a[2] == b[2]
            assert a[1].replace("merged.port", "merged.jax") == b[1]
        else:
            assert a == b
    return ours[4]


def _synthetic_rank_trace(path: Path, rank: int, seed: int,
                          with_clock: bool = True) -> None:
    """A per-rank trace with a negotiation span (rank 0) and lifecycle
    chains over a few cycles, written through the port's Timeline."""
    rng = random.Random(seed)
    tl = timeline.Timeline(str(path), rank=rank, activate=False)
    for cycle in range(1, 5):
        tl.set_cycle(cycle)
        names = [f"t{i}" for i in range(3)]
        if rank == 0:
            for n in names:
                tl.negotiate_start(n, "ALLREDUCE")
                for r in rng.sample([0, 1], 2):
                    time.sleep(1e-4)
                    tl.negotiate_rank_ready(n, r)
                tl.negotiate_end(n)
        response = SimpleNamespace(
            response_type=SimpleNamespace(name="ALLREDUCE"), _cycle=cycle)
        entries = [SimpleNamespace(tensor_name=n) for n in names]
        tl.op_start(response, entries)
        for stage in ("LC_FUSE", "LC_WIRE_REDUCE_SCATTER",
                      "LC_WIRE_ALLGATHER", "LC_UNFUSE"):
            for n in names:
                tl.lifecycle(n, stage, True)
            time.sleep(rng.random() * 1e-3)
            for n in names:
                tl.lifecycle(n, stage, False)
        tl.op_end(response, entries)
        for n in names:
            tl.lifecycle(n, "LC_CALLBACK", True)
            tl.lifecycle(n, "LC_CALLBACK", False)
    tl.close()
    if not with_clock:
        events = [e for e in json.loads(path.read_text())
                  if e["name"] != timeline.CLOCK_SYNC_EVENT]
        path.write_text(json.dumps(events))


@pytest.mark.parametrize("with_clock", [True, False])
def test_the_tools_agree_on_synthetic_traces(tmp_path, with_clock):
    inputs = [tmp_path / "tl.json", tmp_path / "tl.json.rank1"]
    for rank, path in enumerate(inputs):
        _synthetic_rank_trace(path, rank, seed=rank,
                              with_clock=with_clock or rank == 0)
    report = _tools_agree(tmp_path, inputs)
    assert [s["cycle"] for s in report["steps"]] == [1, 2, 3, 4]
    assert report["ranks_seen"] == [0, 1]


def test_the_tools_agree_on_a_truncated_input(tmp_path):
    inputs = [tmp_path / "tl.json", tmp_path / "tl.json.rank1"]
    for rank, path in enumerate(inputs):
        _synthetic_rank_trace(path, rank, seed=10 + rank)
    text = inputs[1].read_text()
    inputs[1].write_text(text[:len(text) * 2 // 3])
    _tools_agree(tmp_path, inputs)


def test_the_tools_agree_on_the_port_job(tmp_path, port_job):
    report = _tools_agree(tmp_path, port_job["paths"])
    op_cycles = {c for lanes in port_job["cycles"][0].values() for c in lanes}
    assert op_cycles <= {s["cycle"] for s in report["steps"]}
    assert report["ranks_seen"] == [0, 1]


def test_the_tools_agree_on_the_jax_job(tmp_path, jax_job):
    _tools_agree(tmp_path, jax_job["paths"])


# ---------------------------------------------------------------------------
# (d) np=2: the port through its launcher, the JAX package on its host ring
# ---------------------------------------------------------------------------

_BODY = '''
for step in range({steps}):
    handles = []
    for j in range(2):
        rng = np.random.RandomState(100 * step + 10 * j + rank)
        handles.append(allreduce_async(BF16(rng.randn(7 + j)), f"bf16.{{j}}"))
        handles.append(allreduce_async(FP32(rng.randn(5 + j)), f"fp32.{{j}}"))
    for h in handles:
        synchronize(h)
    # The next step's submissions start after this step's callbacks.
    barrier()
'''.format(steps=STEPS)

_PORT_PRELUDE = '''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
rank = hvd.rank()
BF16 = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
FP32 = lambda a: torch.from_numpy(a.astype(np.float32))
allreduce_async = lambda x, name: hvd.allreduce_async(x, op=hvd.Sum,
                                                      name=name)
synchronize, barrier = hvd.synchronize, hvd.barrier
'''

_PORT_EPILOGUE = '''
hvd.shutdown()
print("WORKER_DONE", rank, flush=True)
'''

_JAX_PRELUDE = '''
import ml_dtypes
from horovod_tpu.frameworks.jax import ops as jax_ops
BF16 = lambda a: a.astype(np.float32).astype(ml_dtypes.bfloat16)
FP32 = lambda a: a.astype(np.float32)
allreduce_async = lambda x, name: jax_ops.allreduce_async(x, op=jax_ops.Sum,
                                                          name=name)
synchronize, barrier = jax_ops.synchronize, jax_ops.barrier
'''


def _load_job(path: Path) -> dict:
    paths = [Path(timeline.rank_trace_path(str(path), r))
             for r in range(SIZE)]
    traces = [trace_merge.load_trace(str(p)) for p in paths]
    return {"paths": paths, "traces": traces,
            "cycles": [_op_cycles(t) for t in traces]}


@pytest.fixture(scope="module")
def port_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("timeline_port")
    script = out / "worker.py"
    script.write_text(_PORT_PRELUDE + _BODY + _PORT_EPILOGUE)
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60")
    env.pop(env_mod.HOROVOD_TIMELINE, None)
    path = out / "tl.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "-np", str(SIZE), "--timeline-filename", str(path),
         "--timeline-mark-cycles", sys.executable, str(script)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np={SIZE} job timed out after {JOB_TIMEOUT}s\n"
                    f"{stdout}\n{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    for r in range(SIZE):
        assert f"WORKER_DONE {r}" in stdout, stdout
    return _load_job(path)


@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    path = tmp_path_factory.mktemp("timeline_jax") / "tl.json"
    run_distributed(SIZE, _JAX_PRELUDE + _BODY, timeout=45, retries=1,
                    extra_env={"HOROVOD_MESH_STARTUP_TIMEOUT": "60",
                               "HOROVOD_TIMELINE": str(path)})
    return _load_job(path)


def _lane_tids(events) -> dict:
    return {e["args"]["name"]: e["tid"] for e in events
            if e.get("name") == "thread_name"}


def _lane(events, lane: str) -> list:
    """(name, ph, args) of the lane's B/E/i records in write order, each E
    named after the span it closes."""
    tid = _lane_tids(events)[lane]
    stack, out = [], []
    for e in events:
        if e.get("tid") != tid or e["ph"] == "M":
            continue
        if e["ph"] == "B":
            stack.append(e["name"])
            out.append((e["name"], "B", e.get("args")))
        elif e["ph"] == "E":
            out.append((stack.pop(), "E", None))
        else:
            out.append((e["name"], e["ph"], e.get("args")))
    assert not stack, (lane, stack)
    return out


_STEP_SPANS = ("LC_RS_STEP", "LC_AG_STEP")


def _lifecycle(events, lane: str, drop=()) -> list:
    """The lane's op and ``LC_*`` records as (name, ph), without ``drop``."""
    return [(n, ph) for n, ph, _ in _lane(events, lane)
            if (n.startswith("LC_") or n == "ALLREDUCE") and n not in drop]


def _op_cycles(events) -> dict:
    """Per lane, the cycles of its op spans."""
    return {lane: [a["cycle"] for n, ph, a in _lane(events, lane)
                   if n == "ALLREDUCE" and ph == "B"]
            for lane in _lane_tids(events)
            if lane.startswith(("bf16.", "fp32."))}


_TENSORS = [f"{dt}.{j}" for dt in ("bf16", "fp32") for j in range(2)]


@pytest.mark.parametrize("rank", range(SIZE))
@pytest.mark.parametrize("lane", ["bf16.0", "bf16.1"])
def test_bf16_lanes_carry_the_jax_ring_sequence(port_job, jax_job, rank,
                                                lane):
    ours = _lifecycle(port_job["traces"][rank], lane, drop=_STEP_SPANS)
    theirs = _lifecycle(jax_job["traces"][rank], lane, drop=_STEP_SPANS)
    assert ours == theirs
    per_step = [("LC_SUBMITTED", "B"), ("LC_SUBMITTED", "E"),
                ("LC_NEGOTIATED", "i"), ("ALLREDUCE", "B"),
                ("LC_FUSE", "B"), ("LC_FUSE", "E"),
                ("LC_WIRE_REDUCE_SCATTER", "B"),
                ("LC_WIRE_REDUCE_SCATTER", "E"),
                ("LC_WIRE_ALLGATHER", "B"), ("LC_WIRE_ALLGATHER", "E"),
                ("LC_UNFUSE", "B"), ("LC_UNFUSE", "E"), ("ALLREDUCE", "E"),
                ("LC_CALLBACK", "B"), ("LC_CALLBACK", "E")]
    assert ours == per_step * STEPS


@pytest.mark.parametrize("job", ["port", "jax"])
@pytest.mark.parametrize("rank", range(SIZE))
def test_each_bf16_response_has_one_hop_span_per_ring_step(port_job, jax_job,
                                                           job, rank):
    events = (port_job if job == "port" else jax_job)["traces"][rank]
    cycles = _op_cycles(events)
    responses = {c for lane in ("bf16.0", "bf16.1") for c in cycles[lane]}
    for span in _STEP_SPANS:
        hops = sum(1 for lane in ("bf16.0", "bf16.1")
                   for n, ph, _ in _lane(events, lane)
                   if n == span and ph == "B")
        assert hops == (SIZE - 1) * len(responses), (span, hops)
    # Each hop nests in its wire phase.
    for lane in ("bf16.0", "bf16.1"):
        wire = None
        for n, ph, _ in _lane(events, lane):
            if n.startswith("LC_WIRE_"):
                wire = n if ph == "B" else None
            elif n in _STEP_SPANS and ph == "B":
                assert wire == ("LC_WIRE_REDUCE_SCATTER" if n == "LC_RS_STEP"
                                else "LC_WIRE_ALLGATHER")


@pytest.mark.parametrize("rank", range(SIZE))
@pytest.mark.parametrize("lane", ["fp32.0", "fp32.1"])
def test_fp32_lanes_hold_one_wire_span_for_the_gloo_sum(port_job, jax_job,
                                                        rank, lane):
    ours = _lifecycle(port_job["traces"][rank], lane)
    theirs = _lifecycle(jax_job["traces"][rank], lane,
                        drop=_STEP_SPANS + ("LC_WIRE_ALLGATHER",))
    assert ours == theirs
    names = {n for n, _ in ours}
    assert "LC_WIRE_REDUCE_SCATTER" in names
    assert not names & {"LC_WIRE_ALLGATHER", *_STEP_SPANS}


@pytest.mark.parametrize("job", ["port", "jax"])
def test_rank_0_negotiates_with_both_ranks_ticks(port_job, jax_job, job):
    traces = (port_job if job == "port" else jax_job)["traces"]
    for lane in _TENSORS:
        spans = [(n, a) for n, ph, a in _lane(traces[0], lane)
                 if n.startswith("NEGOTIATE_")]
        assert spans and {n for n, _ in spans} == {"NEGOTIATE_ALLREDUCE"}
        ticks = [n for n, ph, _ in _lane(traces[0], lane) if ph == "i"
                 and n.isdigit()]
        assert set(ticks) == {"0", "1"}
    # Only rank 0 holds the message table.
    for lane in _TENSORS:
        assert not any(n.startswith("NEGOTIATE_")
                       for n, _, _ in _lane(traces[1], lane))


@pytest.mark.parametrize("job", ["port", "jax"])
def test_both_ranks_tag_each_op_with_the_same_cycle(port_job, jax_job, job):
    cycles = (port_job if job == "port" else jax_job)["cycles"]
    assert set(cycles[0]) == set(_TENSORS)
    for lane in _TENSORS:
        assert len(cycles[0][lane]) == STEPS
        assert cycles[0][lane] == cycles[1][lane], lane
        assert cycles[0][lane] == sorted(cycles[0][lane])


def test_the_port_job_marks_cycles_and_names_its_ranks(port_job):
    for rank, events in enumerate(port_job["traces"]):
        assert events[0]["args"]["name"] == f"horovod_tpu_torch rank {rank}"
        sync = next(e for e in events
                    if e["name"] == timeline.CLOCK_SYNC_EVENT)
        assert sync["pid"] == rank and sync["args"]["rank"] == rank
        # Estimated from the launcher's rendezvous server's GET /clock.
        assert isinstance(sync["args"]["server_offset_ns"], int)
        marks = [e["args"]["cycle"] for e in events if e["name"] == "CYCLE"]
        assert marks and marks == sorted(marks)
        # Every LC_NEGOTIATED names the cycle of the op it precedes.
        for lane in _TENSORS:
            seq = _lane(events, lane)
            for i, (n, ph, a) in enumerate(seq):
                if n == "LC_NEGOTIATED":
                    assert seq[i + 1][0] == "ALLREDUCE"
                    assert seq[i + 1][2]["cycle"] == a["cycle"]


def test_critical_path_attributes_the_port_job(port_job):
    doc = critical_path.analyze(trace_merge.merge(port_job["traces"]))
    ops = {c for lanes in port_job["cycles"][0].values() for c in lanes}
    steps = {s["cycle"]: s for s in doc["steps"]}
    assert ops <= set(steps)
    for cycle in ops:
        assert set(steps[cycle]["phases_us"]) == {"0", "1"}
        for rank in ("0", "1"):
            phases = steps[cycle]["phases_us"][rank]
            assert phases["fusion"] > 0 and phases["reduce"] > 0
    # Negotiation: the table rounds' spans charge the last-ready rank.
    assert sum(d["negotiation_wait"] for d in doc["totals_us"].values()) > 0


# ---------------------------------------------------------------------------
# (e) the knobs and the entry points
# ---------------------------------------------------------------------------

@pytest.fixture
def no_timeline_env(monkeypatch):
    for name in (env_mod.HOROVOD_TIMELINE, env_mod.HOROVOD_TIMELINE_MARK_CYCLES,
                 env_mod.HOROVOD_TIMELINE_CONTROL_PLANE):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    hvd.shutdown()


def _writers() -> list:
    return [t for t in threading.enumerate() if t.name == "horovod-timeline"]


def test_horovod_timeline_is_honoured(tmp_path, no_timeline_env):
    path = tmp_path / "tl.json"
    no_timeline_env.setenv(env_mod.HOROVOD_TIMELINE, str(path))
    no_timeline_env.setenv(env_mod.HOROVOD_TIMELINE_MARK_CYCLES, "1")
    hvd.init(device="cpu")
    assert timeline.ACTIVE is global_state().timeline is not None
    assert global_state().controller.timeline is timeline.ACTIVE
    hvd.allreduce(torch.ones(3), name="x")
    hvd.shutdown()
    assert timeline.ACTIVE is None and not _writers()
    events = json.loads(path.read_text())
    assert [n for n, _ in _lifecycle(events, "x")] == [
        "LC_SUBMITTED", "LC_SUBMITTED", "LC_NEGOTIATED", "ALLREDUCE",
        "ALLREDUCE", "LC_CALLBACK", "LC_CALLBACK"]
    assert any(e["name"] == "NEGOTIATE_ALLREDUCE" for e in events)
    assert any(e["name"] == "CYCLE" for e in events)


def test_control_plane_spans_land_on_the_active_timeline(tmp_path,
                                                        no_timeline_env):
    """The knob is no longer refused, and each store round trip of the
    rendezvous client is an RVC_* span on the active timeline while the
    spans are on."""
    from horovod_tpu_torch.runner.rendezvous import RendezvousServer
    from horovod_tpu_torch.transport.store import HTTPStoreClient

    path = tmp_path / "tl.json"
    no_timeline_env.setenv(env_mod.HOROVOD_TIMELINE_CONTROL_PLANE, "1")
    no_timeline_env.setenv(env_mod.HOROVOD_TIMELINE, str(path))
    hvd.init(device="cpu")
    srv = RendezvousServer(bind_addr="127.0.0.1")
    client = HTTPStoreClient("127.0.0.1", srv.start(), 10.0)
    try:
        client.set("s", "k", b"v")
        assert client.get("s", "k") == b"v"
        client.batch([("get", "s", "k"), ("keys", "s")])
        no_timeline_env.setattr(timeline, "CONTROL_PLANE_ENABLED", False)
        client.get("s", "k")
    finally:
        srv.stop()
    hvd.shutdown()
    spans = [e for e in json.loads(path.read_text()) if e.get("ph") == "X"]
    assert [e["name"] for e in spans] == ["RVC_SET", "RVC_GET", "RVC_BATCH"]
    assert spans[2]["args"] == {"ops": 2}


def test_no_timeline_means_no_file_and_no_writer(tmp_path, no_timeline_env):
    no_timeline_env.chdir(tmp_path)
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(3), name="x")
    assert timeline.ACTIVE is None and global_state().timeline is None
    assert global_state().controller.timeline is None
    assert not _writers()
    hvd.shutdown()
    assert list(tmp_path.iterdir()) == []


def test_start_and_stop_timeline(tmp_path, no_timeline_env):
    hvd.init(device="cpu")
    first, second = tmp_path / "a.json", tmp_path / "b.json"
    hvd.start_timeline(str(first))
    hvd.allreduce(torch.ones(2), name="one")
    # A second start closes the first.
    hvd.start_timeline(str(second), mark_cycles=True)
    assert len(_writers()) == 1
    hvd.allreduce(torch.ones(2), name="two")
    hvd.stop_timeline()
    assert timeline.ACTIVE is None and not _writers()
    assert global_state().controller.timeline is None
    hvd.allreduce(torch.ones(2), name="three")
    lanes = [{e["args"]["name"] for e in json.loads(p.read_text())
              if e["name"] == "thread_name"} for p in (first, second)]
    assert lanes == [{"one"}, {"two"}]
    assert any(e["name"] == "CYCLE" for e in json.loads(second.read_text()))
    hvd.stop_timeline()


def test_synchronize_records_its_wait(no_timeline_env):
    hvd.init(device="cpu")
    before = timeline.phase_stats.snapshot().get("wait", {}).get("count", 0)
    h = hvd.allreduce_async(torch.ones(2), name="w")
    hvd.synchronize(h)
    hvd.synchronize_many([hvd.allreduce_async(torch.ones(2), name="v")])
    assert timeline.phase_stats.snapshot()["wait"]["count"] == before + 2
    assert timeline.phase_stats.snapshot()["negotiate"]["count"] > 0
