"""The port's fault injection against the JAX package's.

In one process, no job:

- ``common/faults.py``'s parser against ``horovod_tpu.common.faults``: the
  same fields for the same clauses, a ``ValueError`` from both on the bad
  clauses of ``tests/test_fault_injection.py``
  (``TestFaultSpec.test_grammar_errors_are_loud``), and the sites whose
  layer the port lacks (the transports, the journaled rendezvous server's
  handler) refused by the port alone, naming the item that brings them;
- the ``nth``/``after``/``rank`` firing sequences of both modules on the
  same call sequences, and ``inject_deferred``'s delays;
- ``HOROVOD_FAULT_SPEC`` read when the package is imported (a subprocess);
- each wired site fires: ``enqueue.collective``, ``dispatch.collective``
  and ``controller.negotiate`` through the size-1 runtime,
  ``controller.tally``'s parked tally and its replay against the JAX
  controller's, ``worker.spawn`` through the launcher's spawn; each fire
  counted in the metrics and the flight recorder.  ``ckpt.save`` is held
  in ``test_torch_checkpoint.py``; ``store.put``, ``rendezvous.get`` and
  ``driver.tick`` in ``test_torch_elastic_driver.py``.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.common import faults as jax_faults
from horovod_tpu.common.exceptions import \
    FaultInjectedError as JaxFaultInjectedError
from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import controller as jax_controller
from horovod_tpu.core import messages as jax_messages
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common.exceptions import (
    FaultInjectedError,
    HorovodInternalError,
)
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller, flight_recorder, messages
from horovod_tpu_torch.core import metrics
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner.hosts import SlotInfo

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("site", "rank", "peer", "nth", "after", "action", "action_arg")

# tests/test_fault_injection.py's TestFaultSpec.test_grammar_errors_are_loud.
BAD_CLAUSES = ["nosuch.site:action=raise",
               "tcp.send:action=explode",
               "tcp.send:frobnicate",
               "tcp.send:nth=0:action=raise",
               "tcp.send:nth=1:after=2:action=raise",
               "tcp.recv:action=drop",
               "dispatch.collective:action=drop",
               "tcp.recv:action=corrupt",
               "rendezvous.get:action=truncate,3",
               "ckpt.save:action=corrupt,2"]

# Clauses on the sites the port has.
GOOD_CLAUSES = ["enqueue.collective",
                "dispatch.collective:action=delay_ms,500",
                "controller.negotiate:rank=1:nth=3:action=hang",
                "controller.tally:rank=2:after=4:action=delay_ms,60",
                "worker.spawn:rank=2:action=raise",
                "ckpt.save:nth=3:action=exit,9",
                "enqueue.collective:peer=1:action=raise_oserror",
                " dispatch.collective : rank = 0 : action = exit ",
                "controller.negotiate:action=raise"]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture
def fresh_registries(monkeypatch):
    monkeypatch.setattr(metrics, "registry", metrics.MetricsRegistry())
    monkeypatch.setattr(flight_recorder, "recorder",
                        flight_recorder.FlightRecorder())


def _fields(clause):
    return tuple(getattr(clause, k) for k in FIELDS)


# ---------------------------------------------------------------------------
# the grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", GOOD_CLAUSES)
def test_a_clause_parses_to_the_jax_fields(text):
    assert _fields(faults._parse_clause(text)) == \
        _fields(jax_faults._parse_clause(text))


@pytest.mark.parametrize("text", BAD_CLAUSES)
def test_a_bad_clause_raises_in_both(text):
    with pytest.raises(ValueError):
        jax_faults.configure(text)
    with pytest.raises(ValueError):
        faults.configure(text)
    assert not faults.ACTIVE


@pytest.mark.parametrize("site", sorted(faults.MISSING_SITES))
def test_a_site_the_port_lacks_is_refused_naming_its_slice(site):
    text = f"{site}:rank=1:action=raise"
    jax_faults.configure(text)      # the JAX package has the layer
    assert jax_faults.ACTIVE
    with pytest.raises(ValueError) as err:
        faults.configure(text)
    slice_ = "A9" if site.split(".")[0] in ("tcp", "shm") else "A6"
    assert f"ROADMAP {slice_}" in str(err.value)
    assert repr(site) in str(err.value)
    assert not faults.ACTIVE


def test_the_sites_and_actions_are_the_jax_lists():
    assert faults.SITES == jax_faults.SITES
    assert faults._ACTIONS == jax_faults._ACTIONS
    assert set(faults.MISSING_SITES) <= set(faults.SITES)
    wired = set(faults.SITES) - set(faults.MISSING_SITES)
    assert wired == {"enqueue.collective", "dispatch.collective",
                     "controller.negotiate", "controller.tally",
                     "worker.spawn", "ckpt.save", "store.put",
                     "rendezvous.get", "store.get_serve", "driver.tick"}


# ---------------------------------------------------------------------------
# firing sequences
# ---------------------------------------------------------------------------

def _fires(mod, error, calls):
    out = []
    for site, rank in calls:
        try:
            mod.inject(site, rank=rank)
            out.append(False)
        except error:
            out.append(True)
    return out


SEQUENCES = [
    ("enqueue.collective:nth=3:action=raise",
     [("enqueue.collective", 0)] * 6),
    ("enqueue.collective:after=2:action=raise",
     [("enqueue.collective", 0)] * 5),
    ("dispatch.collective:rank=0:nth=1:action=raise;"
     "dispatch.collective:rank=1:nth=2:action=raise",
     [("dispatch.collective", 0), ("dispatch.collective", 1),
      ("dispatch.collective", 1), ("dispatch.collective", 0)]),
    ("controller.negotiate:rank=2:after=1:action=raise",
     [("controller.negotiate", r) for r in (0, 2, 1, 2, 2, 0)]),
    ("worker.spawn:action=raise",
     [("worker.spawn", 0), ("enqueue.collective", 0), ("worker.spawn", 3)]),
]


@pytest.mark.parametrize("spec,calls", SEQUENCES)
def test_firing_sequences_equal_the_jax_module(spec, calls):
    faults.configure(spec)
    jax_faults.configure(spec)
    for _ in range(2):      # the same spec fires the same calls every run
        got = _fires(faults, FaultInjectedError, calls)
        want = _fires(jax_faults, JaxFaultInjectedError, calls)
        assert got == want and any(got)
        faults.configure(spec)
        jax_faults.configure(spec)


def test_inject_deferred_returns_the_delay():
    spec = ("controller.tally:rank=1:after=1:action=delay_ms,250;"
            "controller.tally:rank=2:nth=2:action=delay_ms")
    faults.configure(spec)
    jax_faults.configure(spec)
    calls = [1, 1, 2, 2, 0, 1, 2]
    got = [faults.inject_deferred("controller.tally", rank=r) for r in calls]
    want = [jax_faults.inject_deferred("controller.tally", rank=r)
            for r in calls]
    assert got == want == [0.0, 0.25, 0.0, 0.1, 0.0, 0.25, 0.0]


def test_delay_sleeps_and_returns_false():
    faults.configure("dispatch.collective:action=delay_ms,150")
    t0 = time.monotonic()
    assert faults.inject("dispatch.collective", rank=0) is False
    assert time.monotonic() - t0 >= 0.14


def test_raise_oserror_is_a_connection_reset():
    faults.configure("worker.spawn:action=raise_oserror")
    with pytest.raises(OSError, match="injected connection reset"):
        faults.inject("worker.spawn", rank=0)


def test_the_default_rank_is_the_launchers(monkeypatch):
    faults.configure("enqueue.collective:rank=3:action=raise")
    monkeypatch.setenv("HOROVOD_RANK", "2")
    faults.inject("enqueue.collective")
    monkeypatch.setenv("HOROVOD_RANK", "3")
    with pytest.raises(FaultInjectedError, match=r"rank 3, call 1"):
        faults.inject("enqueue.collective")


def test_a_fire_is_counted_and_recorded(fresh_registries):
    faults.configure("ckpt.save:nth=2:action=raise")
    faults.inject("ckpt.save", rank=0)
    with pytest.raises(FaultInjectedError):
        faults.inject("ckpt.save", rank=0)
    assert metrics.registry.get_counter("faults_injected_total") == 1
    events = [e for e in flight_recorder.recorder.events()
              if e["kind"] == "fault"]
    assert [(e["site"], e["rank"], e["action"], e["call"])
            for e in events] == [("ckpt.save", 0, "raise", 2)]


# ---------------------------------------------------------------------------
# HOROVOD_FAULT_SPEC at import
# ---------------------------------------------------------------------------

_PROBE = ("import horovod_tpu_torch\n"
          "from horovod_tpu_torch.common import faults\n"
          "print(faults.ACTIVE, [(c.site, c.nth, c.action, c.action_arg) "
          "for c in faults._clauses])\n")


def _import_with(spec):
    env = dict(os.environ, HOROVOD_FAULT_SPEC=spec)
    return subprocess.run([sys.executable, "-c", _PROBE], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=60)


def test_the_spec_configures_the_port_at_import():
    done = _import_with("ckpt.save:nth=3:action=exit,9;"
                        "enqueue.collective:action=delay_ms,5")
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == (
        "True [('ckpt.save', 3, 'exit', '9'), "
        "('enqueue.collective', None, 'delay_ms', '5')]")


@pytest.mark.parametrize("spec,text", [
    ("tcp.recv:rank=1:after=3:action=hang", "ROADMAP A9"),
    ("ckpt.sav:action=raise", "unknown fault site 'ckpt.sav'"),
])
def test_a_spec_the_port_cannot_honour_fails_the_import(spec, text):
    done = _import_with(spec)
    assert done.returncode != 0
    assert "ValueError" in done.stderr and text in done.stderr


# ---------------------------------------------------------------------------
# the wired sites
# ---------------------------------------------------------------------------

@pytest.fixture
def size_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_enqueue_collective_fires_in_the_callers_thread(size_one,
                                                        fresh_registries):
    faults.configure("enqueue.collective:nth=2:action=raise")
    t = torch.arange(4, dtype=torch.float32)
    assert torch.equal(hvd.allreduce(t, op=hvd.Sum, name="a"), t)
    with pytest.raises(FaultInjectedError, match="enqueue.collective"):
        hvd.allreduce(t, op=hvd.Sum, name="b")
    assert torch.equal(hvd.allreduce(t, op=hvd.Sum, name="c"), t)
    assert metrics.registry.get_counter("faults_injected_total") == 1


@pytest.mark.parametrize("site", ["dispatch.collective",
                                  "controller.negotiate"])
def test_a_background_site_fails_the_waiting_collective(size_one, site):
    t = torch.ones(3)
    assert torch.equal(hvd.allreduce(t, op=hvd.Sum, name="before"), t)
    faults.configure(f"{site}:rank=0:action=raise")
    with pytest.raises(HorovodInternalError,
                       match=f"injected fault at {site} \\(rank 0"):
        hvd.allreduce(t, op=hvd.Sum, name="after")


def _tally_req(mod, rank):
    return mod.Request(request_rank=rank,
                       request_type=mod.RequestType.ALLREDUCE,
                       tensor_name="g", tensor_type=mod.DataType.FLOAT32,
                       tensor_shape=[4])


def test_controller_tally_parks_and_replays_like_jax(monkeypatch):
    """A delay on rank 1's tallies parks them at rank 0 of both
    controllers; the tensor completes only once the delay has passed."""
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    spec = "controller.tally:rank=1:action=delay_ms,300"
    faults.configure(spec)
    jax_faults.configure(spec)
    ours = controller.Controller(
        ProcessTopology(rank=0, size=2, local_size=2), object())
    theirs = jax_controller.Controller(
        JaxTopology(rank=0, size=2, local_size=2), None)
    trace = []
    for ctl, mod in ((ours, messages), (theirs, jax_messages)):
        steps = [ctl._increment(_tally_req(mod, 0)),
                 ctl._increment(_tally_req(mod, 1)),
                 len(ctl._deferred_tallies)]
        now[0] += 0.2
        steps.append(ctl._mature_deferred_tallies())
        now[0] += 0.2
        steps.append(ctl._mature_deferred_tallies())
        steps.append(len(ctl._deferred_tallies))
        trace.append(steps)
        now[0] = 100.0
    assert trace[0] == trace[1] == [False, False, 1, [], ["g"], 0]


def test_a_cycle_completes_a_parked_tally_once_it_is_due(monkeypatch):
    """Through the coordinator's cycle: rank 1's request arrives in cycle
    1 and is parked; cycle 2, after the delay, answers the tensor."""
    now = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    faults.configure("controller.tally:rank=1:nth=1:action=delay_ms,50")
    ctl = controller.Controller(
        ProcessTopology(rank=0, size=2, local_size=2), object(),
        cache_capacity=0)
    frame = messages.RequestList(
        requests=[_tally_req(messages, 1)]).to_bytes()
    _, first = ctl._coordinate([_tally_req(messages, 0)], [b"", frame],
                               False)
    assert first.responses == []
    now[0] += 0.1
    idle = messages.RequestList(requests=[]).to_bytes()
    _, second = ctl._coordinate([], [b"", idle], False)
    assert [r.tensor_names for r in second.responses] == [["g"]]


def test_worker_spawn_fires_on_the_slots_rank(tmp_path):
    faults.configure("worker.spawn:rank=1:action=raise")
    slot = SlotInfo(hostname="localhost", rank=0, local_rank=0, cross_rank=0,
                    size=2, local_size=2, cross_size=1)
    proc = launch.spawn_worker(slot, [sys.executable, "-c", "pass"],
                               dict(os.environ))
    proc.communicate(timeout=30)
    assert proc.returncode == 0
    slot = dataclasses.replace(slot, rank=1, local_rank=1)
    with pytest.raises(FaultInjectedError, match=r"worker.spawn \(rank 1"):
        launch.spawn_worker(slot, [sys.executable, "-c", "pass"],
                            dict(os.environ))
