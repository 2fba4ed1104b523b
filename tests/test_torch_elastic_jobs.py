"""Elastic jobs through the port's launcher, beside the JAX package's.

- One training body, run by the port through ``python -m
  horovod_tpu_torch.runner.launch -np 2 --min-np 1 --max-np 2
  --host-discovery-script`` and by the JAX package through its own
  launcher.  The body pauses at batch 3 at size 2, where rank 0 drops the
  host ``127.0.0.1`` from the hosts file, and at batch 5 at size 1, where
  it adds the host back (the port's run only: the JAX package hangs
  there, its survivor skipping the sync that the process which joined
  waits in).  The per-rank ``(batch, size)`` sequences up to the shrink
  must be equal (exact); the port's job must then grow, sync the joiner
  from the survivor (the same state hash on both ranks) and finish.  In
  the port's job rank 1's first store read in each process fails (a
  planted ``rendezvous.get`` fault): the reshard marker's read is retried,
  never decided by one rank alone.
- ``examples/torch_port/pytorch_resnet50_elastic.py`` at np=2 on the CPU,
  with a host dropped mid-run: the survivor finishes at size 1.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from .torch_port import one_torch_thread  # noqa: F401  (autouse)
from .torch_port import run_job

REPO = Path(__file__).resolve().parent.parent

_BODY = textwrap.dedent("""
    import hashlib, os, sys, time
    PORT = os.environ["BODY_PACKAGE"] == "port"
    HOSTS = os.environ["HOSTS_FILE"]
    PLAN = {3: (2, "localhost:1\\n"), 5: (1, "localhost:1\\n127.0.0.1:1\\n")}
    TOTAL = int(os.environ["TOTAL"])
    if PORT:
        import torch
        import horovod_tpu_torch as hvd
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

        def step():
            g = torch.Generator().manual_seed(100 * state.batch + hvd.rank())
            x = torch.randn(16, 4, generator=g)
            y = torch.randint(0, 2, (16,), generator=g)
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
    else:
        import numpy as np
        import jax
        jax.config.update("jax_platforms", "cpu")
        import horovod_tpu as hvd
        hvd.init()
        state = hvd.elastic.ObjectState(batch=0)

        def digest():
            return str(state.batch)

        def step():
            out = hvd.allreduce(np.ones(4, np.float32), op=hvd.Sum, name="g")
            assert np.allclose(np.asarray(out), hvd.size())

    @hvd.elastic.run
    def train(state):
        print(f"ENTER batch={state.batch} rank={hvd.rank()} "
              f"size={hvd.size()} hash={digest()}", flush=True)
        while state.batch < TOTAL:
            want = PLAN.get(state.batch)
            if want is not None and hvd.size() == want[0]:
                if hvd.rank() == 0:
                    with open(HOSTS, "w") as f:
                        f.write(want[1])
                deadline = time.monotonic() + 40
                while time.monotonic() < deadline:
                    state.check_host_updates()
                    time.sleep(0.05)
                raise SystemExit("the host change never arrived")
            step()
            print(f"BATCH {state.batch} rank={hvd.rank()} size={hvd.size()}",
                  flush=True)
            state.batch += 1
            state.commit()

    train(state)
    print("ELASTIC_DONE", hvd.rank(), hvd.size(), flush=True)
    hvd.shutdown()
""")


#: Planted in the port's job: each process's first store read on rank 1
#: fails, which is the reshard-marker read of the epoch it syncs in (the
#: first process at epoch 0, the joiner at the growth's epoch).
_MARKER_FAULT = "rendezvous.get:rank=1:nth=1:action=raise_oserror"


def _job(tmp, package: str, total: int, fault: str = ""):
    hosts = tmp / "hosts.txt"
    hosts.write_text("localhost:1\n127.0.0.1:1\n")
    script = tmp / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts}\n")
    script.chmod(0o755)
    (tmp / "train.py").write_text(_BODY)
    runner = "horovod_tpu_torch" if package == "port" else "horovod_tpu"
    env = {**os.environ, "PYTHONPATH": str(REPO), "BODY_PACKAGE": package,
           "HOSTS_FILE": str(hosts), "TOTAL": str(total),
           "HOROVOD_FAULT_SPEC": fault}
    return run_job(
        [sys.executable, "-m", f"{runner}.runner.launch", "-np", "2",
         "--min-np", "1", "--max-np", "2", "--host-discovery-script",
         str(script), sys.executable, str(tmp / "train.py")],
        60, cwd=str(tmp), env=env)


@pytest.fixture(scope="module")
def port_job(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("port"), "port", 7, _MARKER_FAULT)


@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    return _job(tmp_path_factory.mktemp("jax"), "jax", 5)


def _sequence(out: str):
    return [(int(r), int(b), int(s)) for b, r, s in
            re.findall(r"BATCH (\d+) rank=(\d+) size=(\d+)", out)]


def _by_rank(seq):
    return {r: [(b, s) for rr, b, s in seq if rr == r] for r in (0, 1)}


def test_the_port_shrinks_grows_and_finishes(port_job):
    assert port_job.returncode == 0, port_job.stdout + port_job.stderr
    by_rank = _by_rank(_sequence(port_job.stdout))
    assert by_rank[0] == [(0, 2), (1, 2), (2, 2), (3, 1), (4, 1), (5, 2),
                          (6, 2)], port_job.stdout
    # Rank 1: the first process to the shrink, then the joiner.
    assert by_rank[1] == [(0, 2), (1, 2), (2, 2), (5, 2), (6, 2)]
    assert port_job.stdout.count("ELASTIC_DONE") == 2
    assert "ELASTIC_DONE 0 2" in port_job.stdout


def test_the_joiner_is_synced_from_the_survivor(port_job):
    enters = re.findall(r"ENTER batch=(\d+) rank=(\d+) size=(\d+) hash=(\w+)",
                        port_job.stdout)
    grown = [e for e in enters if e[0] == "5" and e[2] == "2"]
    assert len(grown) == 2 and grown[0][3] == grown[1][3], enters


def test_a_failed_marker_read_on_one_rank_is_retried(port_job):
    """Rank 1's read of the reshard marker fails once at epoch 0 and once
    in the joiner at the growth's epoch, while rank 0 reads the marker: the
    read is retried, so both ranks take the same sync and the job ends."""
    assert port_job.returncode == 0, port_job.stdout + port_job.stderr
    failed = re.findall(r"reading the reshard marker of (\S+) failed",
                        port_job.stderr)
    assert failed == ["127.0.0.1:0", "127.0.0.1:0"], port_job.stderr


def test_the_jax_package_shrinks_the_same_way(jax_job, port_job):
    assert jax_job.returncode == 0, jax_job.stdout[-3000:] + \
        jax_job.stderr[-3000:]
    ours = _by_rank(_sequence(port_job.stdout))
    theirs = _by_rank(_sequence(jax_job.stdout))
    # Up to the shrink (and through the size-1 steps after it).
    assert theirs[0] == ours[0][:5] == [(0, 2), (1, 2), (2, 2), (3, 1),
                                        (4, 1)]
    assert theirs[1] == ours[1][:3]


# ---------------------------------------------------------------------------
# the example, with a host dropped mid-run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def example(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example")
    hosts = tmp / "hosts.txt"
    hosts.write_text("localhost:1\n127.0.0.1:1\n")
    script = tmp / "discover.sh"
    script.write_text(f"#!/bin/sh\ncat {hosts}\n")
    script.chmod(0o755)
    out_path, err_path = tmp / "out.log", tmp / "err.log"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
           "--min-np", "1", "--host-discovery-script", str(script),
           sys.executable,
           str(REPO / "examples" / "torch_port" /
               "pytorch_resnet50_elastic.py"),
           "--device", "cpu", "--batches", "80", "--batch-size", "2",
           "--image-size", "32", "--commit-every", "1"]
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=str(tmp), stdout=out, stderr=err,
                                text=True, start_new_session=True,
                                env={**os.environ, "PYTHONPATH": str(REPO),
                                     "OMP_NUM_THREADS": "1"})
        try:
            deadline = time.monotonic() + 45
            while "size=2" not in out_path.read_text():
                if proc.poll() is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            hosts.write_text("localhost:1\n")
            proc.wait(timeout=max(1.0, deadline + 15 - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            # The launcher and its workers.
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    return proc.returncode, out_path.read_text(), err_path.read_text()


def test_the_example_survives_a_dropped_host(example):
    code, out, err = example
    assert code == 0, out + err
    assert "ELASTIC RESNET DONE" in out
    sizes = re.findall(r"batch (\d+) size=(\d+)", out)
    assert ("2" in {s for _, s in sizes}) and sizes[-1] == ("80", "1"), out
