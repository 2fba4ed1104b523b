"""The port's stall inspector, straggler detector and coordinated abort
against the JAX package.

In one process, with the clock patched: the JAX package's stall-inspector
cases (``tests/test_core_extras.py::TestStallInspector``) and a few more
run against both controllers, which must raise or warn with the same
texts and leave the same state; a failure on the port's rank 0 after
the gather (a stall shutdown, a frame it cannot decode) becomes the
cycle's abort verdict, which a worker raises; the straggler detector and
``DemotionPolicy`` fed the same seeded synthetic lags must give the same
EWMAs, suspects, gauge values and verdicts.

Across processes: one np=3 job through the port's launcher on the CPU
(gloo), run once per module and read by many tests, with a 60 s limit.
Six steps of 20 integer-valued fp32 tensors and one int32 tensor (exact
sums) with the response cache on; then ranks 0 and 1 submit ``stuck``,
which rank 2 never submits, with a stall shutdown time of 2 s: every rank
must raise the same ``HorovodInternalError`` naming ``stuck`` and its
missing rank, and the job must end.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.common.exceptions import \
    HorovodInternalError as JaxInternalError
from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import controller as jax_controller
from horovod_tpu.core import flight_recorder as jax_flight_recorder
from horovod_tpu.core import messages as jax_messages
from horovod_tpu.core import metrics as jax_metrics
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller, flight_recorder, messages
from horovod_tpu_torch.core import metrics

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
PACKAGES = [(controller, messages, ProcessTopology, HorovodInternalError),
            (jax_controller, jax_messages, JaxTopology, JaxInternalError)]


def _req(mod, name="t", shape=(4,), rank=1):
    return mod.Request(request_rank=rank,
                       request_type=mod.RequestType.ALLREDUCE,
                       tensor_name=name, tensor_type=mod.DataType.FLOAT32,
                       tensor_shape=list(shape))


class _Clock:
    """``time.monotonic`` as the real clock plus an offset the test moves
    forward: the JAX package stamps its table entries with the real clock,
    so the patched one must stay in step with it."""

    def __init__(self, monkeypatch):
        self.offset = 0.0
        real = time.monotonic
        monkeypatch.setattr(time, "monotonic", lambda: real() + self.offset)

    def advance(self, seconds: float) -> None:
        self.offset += seconds


@pytest.fixture
def clock(monkeypatch):
    return _Clock(monkeypatch)


@pytest.fixture
def fresh_registries(monkeypatch):
    """Both packages' metrics and flight recorders, fresh for the test."""
    monkeypatch.setattr(metrics, "registry", metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "registry", jax_metrics.MetricsRegistry())
    monkeypatch.setattr(flight_recorder, "recorder",
                        flight_recorder.FlightRecorder())
    monkeypatch.setattr(jax_flight_recorder, "recorder",
                        jax_flight_recorder.FlightRecorder())


def _controllers(warn=0.0, shut=0.0, size=3, cache=1024):
    return [ctl_mod.Controller(topo_cls(rank=0, size=size, local_size=size),
                               object() if ctl_mod is controller else None,
                               stall_warning_secs=warn,
                               stall_shutdown_secs=shut, cache_capacity=cache)
            for ctl_mod, _, topo_cls, _ in PACKAGES]


def _warnings(monkeypatch):
    """The texts both controllers log as warnings, per package."""
    texts = ([], [])
    for out, mod in zip(texts, (controller, jax_controller)):
        monkeypatch.setattr(mod.log, "warning",
                            lambda msg, *a, out=out: out.append(msg % a))
    return texts


# ---------------------------------------------------------------------------
# (d) the stall inspector
# ---------------------------------------------------------------------------

def test_both_knobs_disabled_early_return(clock):
    for ctl, (_, mod, _, _) in zip(_controllers(), PACKAGES):
        ctl._increment(_req(mod, name="stuck", rank=1))
        before = ctl._last_stall_check
        clock.advance(10_000.0)
        ctl._check_stalls()
        assert ctl._last_stall_check == before
        assert "stuck" in ctl._message_table
        clock.advance(-10_000.0)


@pytest.mark.parametrize("warn,shut", [(0.0, 5.0), (60.0, 5.0), (0.0, 1.0)])
def test_shutdown_names_tensor_and_missing_ranks(clock, warn, shut):
    """The shutdown does not depend on the warning, and fires on its own
    schedule when it is the shorter time."""
    ctls = _controllers(warn=warn, shut=shut)
    for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
        ctl._increment(_req(mod, name="grad/w0", rank=1))
    clock.advance(shut + 1.0)
    texts = []
    for ctl, (_, _, _, err) in zip(ctls, PACKAGES):
        with pytest.raises(err) as ei:
            ctl._check_stalls()
        texts.append(str(ei.value))
    assert texts[0] == texts[1]
    assert texts[0] == (f"stall shutdown: tensor grad/w0 incomplete for "
                        f"{shut + 1.0:.0f}s (> {shut}s), missing ranks "
                        f"[0, 2]")


def test_mask_path_cached_stall_shutdown_names_tensor(clock):
    """A bit announced by some ranks only, past the shutdown time: the
    abort names the cached tensor from its template."""
    ctls = _controllers(shut=5.0)
    for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
        bit, _ = ctl._cache.maybe_insert(_req(mod, name="cached/t", rank=0))
        ctl._pending_masks[1] = 1 << bit
        ctl._mask_bit_since[bit] = time.monotonic()
    clock.advance(6.0)
    texts = []
    for ctl, (_, _, _, err) in zip(ctls, PACKAGES):
        with pytest.raises(err) as ei:
            ctl._check_stalls()
        texts.append(str(ei.value))
    assert texts[0] == texts[1] == (
        "stall shutdown: cached tensor cached/t incomplete for 6s (> 5.0s), "
        "missing ranks [0, 2]")


def test_mask_path_warning_converts_and_invalidates(clock, monkeypatch):
    """Past the warning time, a stalled bit's announcements become table
    tallies, its cache entry goes, and the warning names the tensor, the
    ranks that have it and the missing ones."""
    warned = _warnings(monkeypatch)
    ctls = _controllers(warn=5.0)
    for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
        bit, _ = ctl._cache.maybe_insert(_req(mod, name="cached/w", rank=0))
        ctl._pending_masks[1] = 1 << bit
        ctl._mask_bit_since[bit] = time.monotonic()
    clock.advance(6.0)
    for ctl in ctls:
        ctl._check_stalls()
        assert bit not in ctl._mask_bit_since
        assert ctl._message_table["cached/w"].ranks == {1}
        assert ctl._cycle_evictions == [bit]
        assert ctl._stall_completed == []
    assert warned[0] == warned[1] == [
        "cached tensor cached/w announced by ranks [1] stalled for 6s, "
        "missing ranks: [0, 2] — invalidating its cache entry"]


def test_a_stalled_bit_completed_by_its_tallies_goes_out_next_cycle(clock):
    """Rank 2 sent the tensor as a full request and ranks 0 and 1 as bits:
    the table warning drops its cache entry, and the bit's conversion
    through the tombstoned template completes it, for the next cycle."""
    ctls = _controllers(warn=5.0)
    for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
        ctl._cache.maybe_insert(_req(mod, name="live", rank=0))
        bit, _ = ctl._cache.maybe_insert(_req(mod, name="mixed", rank=0))
        ctl._increment(_req(mod, name="mixed", rank=2))
        ctl._pending_masks.update({0: 1 << bit, 1: 1 << bit})
        ctl._mask_bit_since[bit] = time.monotonic()
    clock.advance(6.0)
    for ctl in ctls:
        ctl._check_stalls()
        assert ctl._stall_completed == ["mixed"]
        assert ctl._message_table["mixed"].ranks == {0, 1, 2}
        assert ctl._cycle_evictions == [bit]


def test_a_stalled_bit_converts_when_no_live_entry_is_left(clock):
    """The same with the stalled tensor the cache's only entry.  The JAX
    controller tests the cache's truth value (its length) before reading a
    tombstone, so there it clears the announcements instead and the ranks
    that sent the bit wait on a tensor nothing tracks; the port tests for
    the cache's presence and converts them as above."""
    ours, theirs = _controllers(warn=5.0)
    for ctl, (_, mod, _, _) in zip((ours, theirs), PACKAGES):
        bit, _ = ctl._cache.maybe_insert(_req(mod, name="mixed", rank=0))
        ctl._increment(_req(mod, name="mixed", rank=2))
        ctl._pending_masks.update({0: 1 << bit, 1: 1 << bit})
        ctl._mask_bit_since[bit] = time.monotonic()
    clock.advance(6.0)
    for ctl in (ours, theirs):
        ctl._check_stalls()
    assert ours._stall_completed == ["mixed"]
    assert theirs._stall_completed == [] and \
        theirs._message_table["mixed"].ranks == {2}


def test_table_warning_names_missing_ranks_laggard_and_drops_cache(
        clock, monkeypatch):
    warned = _warnings(monkeypatch)
    ctls = _controllers(warn=5.0)
    for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
        bit, _ = ctl._cache.maybe_insert(_req(mod, name="slow", rank=0))
        ctl._increment(_req(mod, name="slow", rank=0))
        ctl._straggler_ewma.update({1: 0.25, 2: 0.5})
    clock.advance(7.0)
    for ctl in ctls:
        ctl._check_stalls()
        assert ctl._cycle_evictions == [bit]
        assert ctl._cache.lookup(("slow",)) is None
    assert warned[0] == warned[1]
    assert warned[0] == [
        "One or more tensors were submitted to be reduced, gathered or "
        "broadcasted by subset of ranks and are waiting for the remainder: "
        "slow stalled for 7s, missing ranks: [1, 2]; slowest by "
        "readiness-lag EWMA: rank 2 (0.500s)"]


def test_stall_metrics_match(clock, fresh_registries):
    ctls = _controllers(warn=2.0, shut=10.0)
    for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
        ctl._increment(_req(mod, name="a", rank=1))
        ctl._increment(_req(mod, name="b", rank=2))
    clock.advance(3.0)
    for ctl in ctls:
        ctl._check_stalls()
    assert metrics.registry.get_gauge("stalled_tensors") == \
        jax_metrics.registry.get_gauge("stalled_tensors") == 2
    clock.advance(10.0)
    for ctl, (_, _, _, err) in zip(ctls, PACKAGES):
        with pytest.raises(err):
            ctl._check_stalls()
    assert metrics.registry.get_counter("stall_shutdowns_total") == \
        jax_metrics.registry.get_counter("stall_shutdowns_total") == 1


class _Control:
    """Rank 0's transport: the workers' frames in, every broadcast kept."""

    def __init__(self, frames):
        self.frames, self.sent = frames, []

    def gather(self, payload):
        return [payload] + self.frames

    def broadcast(self, payload):
        self.sent.append(payload)
        return payload


@pytest.mark.parametrize("fault", ["stall", "bad_frame"])
def test_a_coordinator_failure_is_the_cycle_verdict(clock, fault):
    """Whatever fails on rank 0 after the gather, the workers waiting in
    that cycle's broadcast get an abort frame and raise its text."""
    idle = messages.MaskFrame().to_bytes()
    frames = [idle, b"junk frame" if fault == "bad_frame" else idle]
    control = _Control(frames)
    ctl = controller.Controller(ProcessTopology(rank=0, size=3,
                                                local_size=3), control,
                                stall_shutdown_secs=1.0)
    ctl._increment(_req(messages, name="stuck", rank=1))
    clock.advance(2.0)
    with pytest.raises(Exception) as ei:
        ctl.compute_response_list([])
    want = str(ei.value) if fault == "stall" else \
        f"ValueError: {ei.value}"
    assert control.sent and messages.is_abort_frame(control.sent[-1])
    frame = messages.AbortFrame.from_bytes(control.sent[-1])
    assert (frame.origin_rank, frame.reason) == (0, want)
    assert want.startswith("stall shutdown: tensor stuck" if fault ==
                           "stall" else "ValueError: bad request-list magic")
    worker = controller.Controller(ProcessTopology(rank=1, size=3,
                                                   local_rank=1,
                                                   local_size=3), object())
    with pytest.raises(HorovodInternalError) as wi:
        worker._apply_reply(control.sent[-1])
    assert str(wi.value) == want


# ---------------------------------------------------------------------------
# (e) the straggler detector
# ---------------------------------------------------------------------------

@pytest.fixture
def frozen_clock(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    return now


@pytest.mark.parametrize("seed", range(3))
def test_straggler_ewmas_suspects_and_verdicts_match(seed, frozen_clock,
                                                     fresh_registries,
                                                     monkeypatch):
    """Busy cycles in which some ranks keep a table entry or a cache bit
    waiting for a seeded time after the median announcer."""
    for key, value in (("HOROVOD_STRAGGLER_THRESHOLD_SECS", "0.5"),
                       ("HOROVOD_STRAGGLER_EWMA_ALPHA", "0.4"),
                       ("HOROVOD_STRAGGLER_DEMOTE_SECS", "0.3"),
                       ("HOROVOD_STRAGGLER_DEMOTE_CYCLES", "3")):
        monkeypatch.setenv(key, value)
    size = 5
    ctls = _controllers(size=size)
    rng = np.random.RandomState(seed)
    slow = int(rng.randint(size))
    flagged = 0
    for cycle in range(30):
        lag = float(rng.choice([0.0, 0.2, 1.0, 2.0]))
        late = {slow} if rng.rand() < 0.8 else set(
            rng.choice(size, 2, replace=False).tolist())
        on_time = [r for r in range(size) if r not in late]
        for ctl, (_, mod, _, _) in zip(ctls, PACKAGES):
            for r in on_time:
                ctl._increment(_req(mod, name=f"t{cycle}", rank=r))
            bit, _ = ctl._cache.maybe_insert(_req(mod, name=f"c{cycle}",
                                                  rank=0))
            for r in on_time:
                ctl._pending_masks[r] = ctl._pending_masks.get(r, 0) | \
                    (1 << bit)
            ctl._mask_bit_majority[bit] = frozen_clock[0]
        frozen_clock[0] += lag
        for ctl in ctls:
            ctl._update_stragglers()
            # The cycle's work completes: nothing carries over.
            ctl._message_table.clear()
            ctl._pending_masks.clear()
            ctl._mask_bit_majority.clear()
        ours, theirs = ctls
        assert ours._straggler_ewma == theirs._straggler_ewma, cycle
        assert ours._straggler_suspects == theirs._straggler_suspects
        assert metrics.registry.get_gauge("straggler_suspect") == \
            jax_metrics.registry.get_gauge("straggler_suspect")
        assert ours.demotion._streak == theirs.demotion._streak
        assert ours.demotion._demoted_epochs == \
            theirs.demotion._demoted_epochs
        flagged += bool(ours._straggler_suspects)
        frozen_clock[0] += 0.01
    assert flagged > 0
    for r in range(size):
        assert metrics.registry.get_counter("straggler_flags_total",
                                            rank=str(r)) == \
            jax_metrics.registry.get_counter("straggler_flags_total",
                                             rank=str(r))
    kinds = [[e["kind"] for e in rec.recorder.events()]
             for rec in (flight_recorder, jax_flight_recorder)]
    assert kinds[0] == kinds[1] and "straggler" in kinds[0]
    assert ("straggler_demotion" in kinds[0]) == \
        bool(ctls[0].demotion._demoted_epochs)
    hists = [reg.registry.snapshot()["histograms"]
             for reg in (metrics, jax_metrics)]
    assert hists[0] == hists[1]


@pytest.mark.parametrize("seed", range(4))
def test_demotion_policy_matches_jax(seed):
    rng = np.random.RandomState(seed)
    ours = controller.DemotionPolicy(0.5, 3)
    theirs = jax_controller.DemotionPolicy(0.5, 3)
    victims = []
    for cycle in range(60):
        active = set(range(int(rng.randint(2, 7))))
        ewma = {r: float(rng.choice([0.0, 0.4, 0.6, 1.5])) for r in active}
        epoch = cycle // 20
        a = ours.observe(epoch, ewma, active)
        assert a == theirs.observe(epoch, ewma, active), cycle
        assert ours._streak == theirs._streak
        victims.append(a)
    assert all(v is None for v in victims[:2])
    with pytest.raises(ValueError, match="DEMOTE_CYCLES"):
        controller.DemotionPolicy(0.5, 0)


@pytest.mark.parametrize("key,value", [
    ("HOROVOD_STRAGGLER_EWMA_ALPHA", "0"),
    ("HOROVOD_STRAGGLER_EWMA_ALPHA", "1.5"),
    ("HOROVOD_FUSION_ORDER", "random"),
])
def test_bad_knobs_raise_as_in_jax(monkeypatch, key, value):
    monkeypatch.setenv(key, value)
    texts = []
    for make in (lambda: _controllers(size=2)[0],
                 lambda: _controllers(size=2)[1]):
        with pytest.raises(ValueError) as ei:
            make()
        texts.append(str(ei.value))
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# (g) the np=3 job
# ---------------------------------------------------------------------------

_WORKER = '''
import json, sys, time
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.core.state import global_state

hvd.init(device="cpu")
rank, size = hvd.rank(), hvd.size()
ctl = global_state().controller
keys = ("serialized_request_count", "cache_hit_count", "cache_miss_count",
        "fast_cycle_count", "idle_fast_cycle_count", "mask_only_sent_count")
info = {"steps": [], "exact": True}
for step in range(6):
    handles = [hvd.allreduce_async(
        torch.full((5 + i,), float((rank + 1) * (step + 1) * (i + 1))),
        op=hvd.Sum, name=f"w{i}") for i in range(20)]
    handles.append(hvd.allreduce_async(
        torch.arange(7, dtype=torch.int32) * (rank + 1) + step, op=hvd.Sum,
        name="count"))
    tri = size * (size + 1) // 2
    for i, h in enumerate(handles[:20]):
        out = hvd.synchronize(h)
        info["exact"] &= bool(torch.equal(out, torch.full(
            (5 + i,), float(tri * (step + 1) * (i + 1)))))
    out = hvd.synchronize(handles[20])
    info["exact"] &= bool(torch.equal(
        out, torch.arange(7, dtype=torch.int32) * tri + size * step))
    info["steps"].append({k: getattr(ctl, k) for k in keys})

t0 = time.monotonic()
if rank == size - 1:
    # Never submits "stuck": its runtime stops with the others', and its
    # next enqueue raises the same error.
    info["loop_ended"] = global_state().shutdown_complete.wait(30)
    try:
        hvd.allreduce(torch.ones(1), name="after")
        info["error"] = ""
    except HorovodInternalError as e:
        info["error"] = str(e)
else:
    h = hvd.allreduce_async(torch.ones(3), name="stuck")
    try:
        hvd.synchronize(h)
        info["error"] = ""
    except HorovodInternalError as e:
        info["error"] = str(e)
    try:
        hvd.allreduce(torch.ones(1), name="after")
        info["next_error"] = ""
    except HorovodInternalError as e:
        info["next_error"] = str(e)
info["abort_seconds"] = time.monotonic() - t0
hvd.shutdown()
with open(f"{sys.argv[1]}/rank{rank}.json", "w") as f:
    json.dump(info, f)
print("WORKER_DONE", rank)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("np3_stall")
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60",
               HOROVOD_FLIGHT_RECORDER_DIR=str(out))
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "3",
         "--stall-check-shutdown-time-seconds", "2", sys.executable,
         str(script), str(out)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np=3 job timed out after {JOB_TIMEOUT}s\n{stdout}\n"
                    f"{stderr}")
    assert proc.returncode == 0, f"{stdout}\n{stderr}"
    for r in range(3):
        assert f"[{r}]<stdout>: WORKER_DONE {r}" in stdout, stdout
    return {"seconds": time.monotonic() - t0, "out": out,
            "ranks": [json.loads((out / f"rank{r}.json").read_text())
                      for r in range(3)]}


def test_steady_state_sums_are_exact(job):
    assert [info["exact"] for info in job["ranks"]] == [True] * 3


@pytest.mark.parametrize("rank", [1, 2])
def test_workers_send_bits_after_the_first_step(job, rank):
    steps = job["ranks"][rank]["steps"]
    assert steps[0]["serialized_request_count"] == 21
    assert all(s["serialized_request_count"] == 21 for s in steps)
    last = steps[-1]
    assert last["cache_hit_count"] >= last["cache_miss_count"] == 21
    assert last["cache_hit_count"] == 5 * 21
    assert last["fast_cycle_count"] > 0
    assert last["mask_only_sent_count"] > 0


def test_coordinator_takes_no_requests_off_the_wire_after_the_first_step(job):
    steps = job["ranks"][0]["steps"]
    assert all(s["serialized_request_count"] == 2 * 21 for s in steps)
    assert steps[-1]["fast_cycle_count"] > 0


def test_withheld_tensor_aborts_every_rank_with_one_text(job):
    errors = [info["error"] for info in job["ranks"]]
    assert len(set(errors)) == 1, errors
    assert errors[0].startswith("stall shutdown: tensor stuck incomplete for ")
    assert errors[0].endswith("(> 2.0s), missing ranks [2]")


@pytest.mark.parametrize("rank", [0, 1])
def test_the_next_enqueue_raises_the_same_text(job, rank):
    info = job["ranks"][rank]
    assert info["next_error"] == info["error"]


def test_the_abort_ends_the_job_without_waiting_for_gloo(job):
    """The gloo timeout is 60 s: the abort arrives within the check period
    after the 2 s shutdown time."""
    assert job["ranks"][2]["loop_ended"] is True
    assert max(info["abort_seconds"] for info in job["ranks"]) < 10
    assert job["seconds"] < JOB_TIMEOUT


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_flight_recorder_dump_names_the_abort(job, rank):
    path = job["out"] / "hvd_flight_recorder" / \
        f"hvd_flight_recorder.rank{rank}.json"
    doc = json.loads(path.read_text())
    assert doc["format"] == "hvd-flight-recorder-v1" and doc["rank"] == rank
    assert job["ranks"][rank]["error"] in doc["reason"]
    assert any(e["kind"] == "cycle" for e in doc["events"])
