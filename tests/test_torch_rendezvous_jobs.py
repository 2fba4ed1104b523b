"""Elastic jobs of the port on the CPU through its supervised rendezvous
server and without the reshard marker.

- The outage job: ``python -m horovod_tpu_torch.runner.rendezvous`` with a
  journal and its own trace, and an np=2 elastic job through the launcher
  (``run_job``) with ``HOROVOD_RENDEZVOUS_EXTERNAL`` and the timelines on.
  While both ranks train, a thread SIGKILLs the server, keeps it down for
  four renewal periods, starts it again on its port over its journal, and
  then drops the host ``127.0.0.1`` (a shrink).  The gates are those of
  ``chip_smoke.py``'s phase 24 but the kernel's: the job exits 0; no reset
  between the kill and the shrink; renewals failed during the outage and
  no worker was shed; the restarted server holds the epoch from before
  the kill, and the shrink's epoch is that + 1; the ranks' states equal at
  every step at size 2; one ``CHURN_EVENT`` per epoch change in the
  driver's trace, whose ``control_path`` phases sum to its coverage.
- The unmarked job: ``HOROVOD_RESHARD=0``, sizes 2, 1, 2: every epoch's
  slot table carries no reshard marker, every rank syncs from rank 0 after
  each reset, and the process that joins holds the survivor's state.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from horovod_tpu_torch.tools import control_path, trace_merge
from horovod_tpu_torch.transport.store import HTTPStoreClient

from .torch_port import one_torch_thread  # noqa: F401  (autouse)
from .torch_port import run_job

REPO = Path(__file__).resolve().parent.parent
KEY = "e" * 64
RENEW_SECS = 0.5
OUTAGE_SECS = 4 * RENEW_SECS
JOB_TIMEOUT = 60
BOTH = "localhost:1\n127.0.0.1:1\n"

_BODY = textwrap.dedent("""
    import hashlib, json, os, sys, time
    from pathlib import Path
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import metrics
    from horovod_tpu_torch.elastic import rendezvous_client as rc
    from horovod_tpu_torch.elastic import state as elastic_state

    OUT = Path(os.environ["JOB_DIR"])
    PLAN = {int(k): v for k, v in json.loads(os.environ["JOB_PLAN"]).items()}
    TOTAL = int(os.environ["JOB_TOTAL"])
    LOG = OUT / f"{os.environ['HOROVOD_HOSTNAME']}.{os.getpid()}.jsonl"

    def record(**fields):
        with open(LOG, "a") as f:
            f.write(json.dumps({"t": time.time(), **fields}) + "\\n")

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model, opt, batch=0)

    def digest():
        h = hashlib.sha256()
        for t in list(model.parameters()) + [
                v for s in inner.state.values() for v in s.values()]:
            h.update(t.detach().numpy().tobytes())
        h.update(str(state.batch).encode())
        return h.hexdigest()

    @hvd.elastic.run
    def train(state):
        epoch = int(os.environ["HOROVOD_EPOCH"])
        record(kind="enter", epoch=epoch, rank=hvd.rank(), size=hvd.size(),
               batch=state.batch, hash=digest(),
               resets=len(elastic_state.reset_log),
               marker=rc.current_reshard_info() if epoch else None)
        while state.batch < TOTAL and not (OUT / "stop").exists():
            plan = PLAN.get(state.batch)
            if plan is not None and hvd.size() == plan[0]:
                if hvd.rank() == 0:
                    (OUT / "hosts.txt").write_text(plan[1])
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    state.check_host_updates()
                    time.sleep(0.02)
                raise AssertionError("the host change never arrived")
            g = torch.Generator().manual_seed(100 * state.batch + hvd.rank())
            x = torch.randn(8, 4, generator=g)
            opt.zero_grad()
            model(x).pow(2).mean().backward()
            opt.step()
            state.batch += 1
            record(kind="step", epoch=int(os.environ["HOROVOD_EPOCH"]),
                   rank=hvd.rank(), size=hvd.size(), batch=state.batch,
                   hash=digest(),
                   failures=metrics.registry.get_counter(
                       "lease_renew_failures_total"))
            state.commit()
            time.sleep(0.1)

    train(state)
    record(kind="done", rank=hvd.rank(), size=hvd.size())
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _logs(out: Path) -> dict:
    return {p.name: [json.loads(line) for line in p.read_text().splitlines()]
            for p in sorted(out.glob("*.jsonl"))}


def _steps(logs: dict, host: str) -> list:
    return [e for name, log in logs.items() if name.startswith(host + ".")
            for e in log if e["kind"] == "step"]


def _wait(what: str, cond, deadline: float) -> None:
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _job_env(tmp: Path, plan: dict, total: int, **extra) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO), "JOB_DIR": str(tmp),
           "JOB_PLAN": json.dumps(plan), "JOB_TOTAL": str(total),
           "HOROVOD_METRICS_PUSH_SECS": str(RENEW_SECS), **extra}
    env.pop("HOROVOD_FAULT_SPEC", None)
    return env


def _launch_cmd(tmp: Path) -> list:
    script = tmp / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {tmp / 'hosts.txt'}\n")
    script.chmod(0o755)
    (tmp / "train.py").write_text(_BODY)
    return [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
            "2", "--min-np", "1", "--max-np", "2",
            "--host-discovery-script", str(script), sys.executable,
            str(tmp / "train.py")]


def _serve(port: int, tmp: Path, n: int) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.rendezvous",
         "--bind", "127.0.0.1", "--port", str(port),
         "--journal-dir", str(tmp / "journal"),
         "--trace", str(tmp / f"server{n}.json")],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO),
             "HOROVOD_SECRET_KEY": KEY,
             "HOROVOD_TIMELINE_CONTROL_PLANE": "1"})
    line = proc.stdout.readline()
    assert line.startswith("rendezvous serving on port"), line
    return proc


@pytest.fixture(scope="module")
def outage_job(tmp_path_factory):
    """The job runs through ``run_job``; a thread plays the supervisor and
    the operator: it kills and restarts the server and drops the host."""
    tmp = tmp_path_factory.mktemp("outage")
    (tmp / "hosts.txt").write_text(BOTH)
    port = _free_port()
    live = {"server": _serve(port, tmp, 0)}
    marks = {}
    ended = threading.Event()

    def wait(what, cond, deadline):
        _wait(what, lambda: ended.is_set() or cond(), deadline)
        if ended.is_set():
            raise AssertionError(f"the job ended before {what}")

    def operate():
        deadline = time.monotonic() + JOB_TIMEOUT
        try:
            wait("both ranks training", lambda: all(
                len(_steps(_logs(tmp), h)) >= 3
                for h in ("localhost", "127.0.0.1")), deadline)
            marks["kill"] = time.time()
            live["server"].send_signal(signal.SIGKILL)
            live["server"].wait(timeout=10)
            time.sleep(OUTAGE_SECS)
            live["server"] = _serve(port, tmp, 1)
            marks["restart"] = time.time()
            marks["replayed_epoch"] = HTTPStoreClient(
                "127.0.0.1", port).get("driver", "epoch")
            wait("steps after the restart", lambda: all(
                any(e["t"] > marks["restart"] + 2 * RENEW_SECS
                    for e in _steps(_logs(tmp), h))
                for h in ("localhost", "127.0.0.1")), deadline)
            marks["shrink"] = time.time()
            (tmp / "hosts.txt").write_text("localhost:1\n")
            wait("two steps at size 1", lambda: sum(
                e["size"] == 1 for e in _steps(_logs(tmp), "localhost"))
                >= 2, deadline)
        except AssertionError as e:
            marks["error"] = str(e)
        finally:
            (tmp / "stop").write_text("")

    operator = threading.Thread(target=operate, name="outage-operator",
                                daemon=True)
    # The operator's client signs with the job's key.
    old_key = os.environ.get("HOROVOD_SECRET_KEY")
    os.environ["HOROVOD_SECRET_KEY"] = KEY
    operator.start()
    try:
        proc = run_job(
            _launch_cmd(tmp), JOB_TIMEOUT, cwd=str(tmp),
            env=_job_env(tmp, {}, 10 ** 6,
                         HOROVOD_RENDEZVOUS_EXTERNAL=f"127.0.0.1:{port}",
                         HOROVOD_SECRET_KEY=KEY,
                         HOROVOD_TIMELINE=str(tmp / "tl.json"),
                         HOROVOD_TIMELINE_CONTROL_PLANE="1"))
    finally:
        ended.set()
        operator.join(timeout=30)
        if old_key is None:
            del os.environ["HOROVOD_SECRET_KEY"]
        else:
            os.environ["HOROVOD_SECRET_KEY"] = old_key
        # SIGTERM: the server closes its trace (the killed one's is lost
        # with its unwritten buffer).
        live["server"].terminate()
        live["server"].wait(timeout=10)
    assert not operator.is_alive()
    return {"code": proc.returncode, "err": proc.stderr, "marks": marks,
            "logs": _logs(tmp), "dir": tmp}


def test_the_outage_job_exits_0_at_size_1(outage_job):
    assert "error" not in outage_job["marks"], outage_job["marks"]
    assert outage_job["code"] == 0, outage_job["err"][-4000:]
    survivor = _steps(outage_job["logs"], "localhost")
    assert survivor[-1]["size"] == 1


def test_no_epoch_changes_for_the_outage(outage_job):
    marks, logs = outage_job["marks"], outage_job["logs"]
    survivor = [e for name, log in logs.items()
                if name.startswith("localhost.") for e in log]
    enters = [e for e in survivor if e["kind"] == "enter"]
    # The start, and the shrink's reset after the hosts file changed.
    assert [e["epoch"] for e in enters] == [0, 1], enters
    assert enters[1]["t"] > marks["shrink"] and enters[1]["resets"] == 1
    for host in ("localhost", "127.0.0.1"):
        before = [e for e in _steps(logs, host) if e["t"] < marks["shrink"]]
        assert before and {(e["size"], e["epoch"]) for e in before} == \
            {(2, 0)}, (host, before)
    # One process per host: nobody was shed and spawned again.
    assert sorted(name.split(".jsonl")[0].rsplit(".", 1)[0]
                  for name in logs) == ["127.0.0.1", "localhost"]


def test_renewals_failed_during_the_outage_and_the_journal_replayed(
        outage_job):
    marks, logs = outage_job["marks"], outage_job["logs"]
    for host in ("localhost", "127.0.0.1"):
        during = [e["failures"] for e in _steps(logs, host)
                  if marks["restart"] < e["t"] < marks["shrink"]]
        assert during and max(during) > 0, host
    assert marks["replayed_epoch"] == b"0"
    shrunk = [e for e in _steps(logs, "localhost") if e["size"] == 1]
    assert {e["epoch"] for e in shrunk} == {int(marks["replayed_epoch"]) + 1}


def test_the_ranks_hold_equal_states_at_size_2(outage_job):
    logs = outage_job["logs"]
    ours = {e["batch"]: e["hash"] for e in _steps(logs, "localhost")
            if e["size"] == 2}
    theirs = {e["batch"]: e["hash"] for e in _steps(logs, "127.0.0.1")}
    common = set(ours) & set(theirs)
    assert len(common) >= 5
    assert all(ours[b] == theirs[b] for b in common)


def test_control_path_splits_the_shrink(outage_job, capsys):
    tmp = outage_job["dir"]
    driver = trace_merge.load_trace(str(tmp / "tl.json.driver"))
    churn = [e for e in driver if e.get("name") == "CHURN_EVENT"]
    assert [e["args"]["epoch"] for e in churn] == [1], churn
    assert {e["name"] for e in driver} >= {"DRV_WAIT", "RVC_BATCH"}
    files = [str(tmp / name) for name in ("server1.json", "tl.json.driver",
                                          "tl.json")]
    assert control_path.main(files + ["--json", str(tmp / "cp.json")]) == 0
    doc = json.loads((tmp / "cp.json").read_text())
    assert doc["event_count"] == 1 and set(doc["pids_seen"]) >= {-1, -2}
    event = doc["events"][0]
    assert sum(event["phases_us"].values()) == pytest.approx(
        event["coverage"] * event["duration_us"], rel=0.01, abs=1.0)
    server = trace_merge.load_trace(str(tmp / "server1.json"))
    assert any(e.get("name") == "JR_REPLAY" for e in server)


# ---------------------------------------------------------------------------
# HOROVOD_RESHARD=0: every epoch unmarked
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unmarked_job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unmarked")
    (tmp / "hosts.txt").write_text(BOTH)
    proc = run_job(_launch_cmd(tmp), JOB_TIMEOUT, cwd=str(tmp),
                   env=_job_env(tmp, {"2": [2, "localhost:1\n"],
                                      "4": [1, BOTH]}, 6,
                                HOROVOD_RESHARD="0"))
    return proc, _logs(tmp)


def test_the_unmarked_job_runs_sizes_2_1_2(unmarked_job):
    proc, logs = unmarked_job
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert [e["size"] for e in _steps(logs, "localhost")] == \
        [2, 2, 1, 1, 2, 2]


def test_every_epoch_after_a_reset_is_unmarked_and_syncs_from_rank_0(
        unmarked_job):
    _, logs = unmarked_job
    enters = [e for log in logs.values() for e in log if e["kind"] == "enter"]
    later = [e for e in enters if e["epoch"] > 0]
    assert {e["epoch"] for e in later} == {1, 2}
    assert all(e["marker"] is None for e in later), later
    # The growth: the process that joined holds the survivor's state.
    grown = sorted((e for e in later if e["epoch"] == 2),
                   key=lambda e: e["rank"])
    assert [e["size"] for e in grown] == [2, 2]
    assert grown[0]["hash"] == grown[1]["hash"]
    assert grown[0]["batch"] == grown[1]["batch"] == 4
