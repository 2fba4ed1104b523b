"""The port's checkpoint protocol against the JAX package's.

In one process:

- ``_payload_crc`` of both packages on the same directory tree;
- a port snapshot (one ``torch.save`` file) passes the JAX
  ``snapshot_valid`` with the same manifest fields, and an orbax snapshot
  written by the JAX ``_publish_snapshot`` passes the port's;
- the same verdict and reason from both on each damage: a missing
  manifest, a flipped payload byte, a garbage manifest, a renamed file;
- ``_list_snapshots`` of both on the same names and decoys;
- the overwrite protocol (the old payload moved aside, no litter) and a
  stale temporary directory of a crashed attempt;
- a small fused ResNet's and its SGD-momentum state's round trip through
  ``save``/``restore`` at size 1, bit for bit, and the next step from the
  restored state equal to the live one's; ``like`` placing and casting.

Across processes, one module-scoped np=2 job through the port's launcher on
the CPU (gloo), with a 60 s limit, run with
``HOROVOD_FAULT_SPEC=ckpt.save:nth=3:action=exit,9``: two rotating saves,
``restore``/``restore_latest`` broadcast to rank 1, a missing checkpoint
raising ``CheckpointNotFoundError`` on both ranks, rank 0's I/O failure
raising ``HorovodInternalError`` on both; then the third save kills rank 0
between the payload's publish and its manifest, and ``restore_latest`` at
size 1 must skip that snapshot with its reason and return the second, as
``tests/test_fault_injection.py``'s kill-mid-save test does for the JAX
package.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.frameworks.jax import checkpoint as jax_ck
from horovod_tpu_torch import checkpoint as ck
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common.exceptions import (
    CheckpointNotFoundError,
    HorovodInternalError,
)
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.training import train_step

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
JOB_TIMEOUT = 60
DAMAGES = ("no_manifest", "flipped_byte", "garbage_manifest", "renamed_file")


@pytest.fixture
def size_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _torch_state(step: int):
    return {"w": torch.arange(4, dtype=torch.float32) * step,
            "nested": {"b": torch.ones(2, 3, dtype=torch.bfloat16) * step,
                       "i": torch.tensor([step, -step])},
            "step": step}


def _jax_state(step: int):
    return {"w": np.arange(4, dtype=np.float32) * step,
            "step": np.asarray(step)}


def _write_tree(root: Path, seed: int) -> None:
    rng = np.random.RandomState(seed)
    for rel in ("a.bin", "z/b.bin", "z/y/c.bin", "m/d.bin", "B.bin"):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(rng.bytes(int(rng.randint(0, 3 << 20))))


def _largest_file(snap: str) -> str:
    files = [os.path.join(d, n) for d, _, names in os.walk(snap)
             for n in names]
    return max(files, key=os.path.getsize)


def _damage(snap: str, kind: str) -> None:
    if kind == "no_manifest":
        os.remove(snap + ck.MANIFEST_SUFFIX)
    elif kind == "flipped_byte":
        victim = _largest_file(snap)
        raw = bytearray(Path(victim).read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        Path(victim).write_bytes(bytes(raw))
    elif kind == "garbage_manifest":
        Path(snap + ck.MANIFEST_SUFFIX).write_text("{not json")
    else:
        victim = _largest_file(snap)
        os.replace(victim, victim + ".moved")


# ---------------------------------------------------------------------------
# the snapshot primitives against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_payload_crc_equals_the_jax_one(tmp_path, seed):
    _write_tree(tmp_path, seed)
    assert ck._payload_crc(str(tmp_path)) == \
        jax_ck._payload_crc(str(tmp_path))


def test_a_port_snapshot_passes_the_jax_check(tmp_path):
    snap = str(tmp_path / "snap")
    manifest = ck._publish_snapshot(snap, _torch_state(7))
    assert os.listdir(snap) == [ck.PAYLOAD_FILE]
    on_disk = json.loads(Path(snap + ck.MANIFEST_SUFFIX).read_text())
    assert on_disk == manifest
    assert sorted(on_disk) == ["bytes", "crc32", "files", "format", "step"]
    assert (on_disk["format"], on_disk["files"], on_disk["step"]) == (1, 1, 7)
    assert on_disk["bytes"] == os.path.getsize(
        os.path.join(snap, ck.PAYLOAD_FILE))
    assert jax_ck.snapshot_valid(snap) == ck.snapshot_valid(snap) == \
        (True, "ok")
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_a_jax_snapshot_passes_the_port_check(tmp_path):
    snap = str(tmp_path / "snap")
    manifest = jax_ck._publish_snapshot(snap, _jax_state(3))
    assert manifest["files"] > 1        # an orbax tree of several files
    assert ck.snapshot_valid(snap) == (True, "ok")


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", DAMAGES)
def test_both_give_the_same_verdict_on_damage(tmp_path, writer, kind):
    snap = str(tmp_path / "snap")
    if writer == "port":
        ck._publish_snapshot(snap, _torch_state(1))
    else:
        jax_ck._publish_snapshot(snap, _jax_state(1))
    _damage(snap, kind)
    ours, theirs = ck.snapshot_valid(snap), jax_ck.snapshot_valid(snap)
    assert ours == theirs
    assert not ours[0]
    assert ours[1].startswith({
        "no_manifest": "no manifest", "flipped_byte": "payload CRC mismatch",
        "garbage_manifest": "manifest unreadable",
        "renamed_file": "payload CRC mismatch"}[kind])


def test_a_missing_payload_directory(tmp_path):
    snap = str(tmp_path / "never")
    assert ck.snapshot_valid(snap) == jax_ck.snapshot_valid(snap) == \
        (False, "payload directory missing")


def test_list_snapshots_orders_and_filters_like_jax(tmp_path):
    base = str(tmp_path / "run")
    for seq in (1, 3, 2, 12):
        ck._publish_snapshot(f"{base}.{seq:08d}", _torch_state(seq))
    os.makedirs(f"{base}.00000009.tmp-123")
    os.makedirs(f"{base}.00000010.old-7")
    os.makedirs(str(tmp_path / "unrelated.00000004"))
    os.makedirs(f"{base}x.00000005")
    os.makedirs(f"{base}.0000006")
    os.makedirs(f"{base}.123456789")
    ours = ck._list_snapshots(base)
    assert ours == jax_ck._list_snapshots(base)
    assert [seq for seq, _ in ours] == [12, 3, 2, 1]
    assert ck._list_snapshots(str(tmp_path / "absent" / "run")) == []


def test_the_overwrite_protocol(tmp_path):
    snap = str(tmp_path / "snap")
    ck._publish_snapshot(snap, _torch_state(1))
    # A crashed attempt's temporary directory is replaced, not reused.
    stale = Path(f"{snap}.tmp-{os.getpid()}")
    stale.mkdir()
    (stale / "junk").write_bytes(b"x" * 100)
    ck._publish_snapshot(snap, _torch_state(2))
    assert ck.snapshot_valid(snap) == (True, "ok")
    assert os.listdir(snap) == [ck.PAYLOAD_FILE]
    assert ck._load_payload(snap)["step"] == 2
    litter = [n for n in os.listdir(tmp_path)
              if ".old-" in n or ".tmp-" in n]
    assert not litter, litter


def test_the_payload_is_on_the_cpu_and_loads_weights_only(tmp_path):
    snap = str(tmp_path / "snap")
    state = _torch_state(4)
    state["w"].requires_grad_(True)
    ck._publish_snapshot(snap, state)
    loaded = torch.load(os.path.join(snap, ck.PAYLOAD_FILE),
                        weights_only=True)
    assert loaded["step"] == 4 and not loaded["w"].requires_grad
    assert loaded["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(loaded["nested"]["i"], torch.tensor([4, -4]))


# ---------------------------------------------------------------------------
# the API at size 1
# ---------------------------------------------------------------------------

def _small_resnet(seed: int = 0):
    return resnet.ResNet(stage_sizes=[1], block_cls=resnet.BottleneckBlock,
                         num_classes=10, num_filters=8, dtype=torch.float32,
                         fuse_conv1x1_bn=True,
                         generator=torch.Generator().manual_seed(seed))


def _batch(seed: int):
    gen = torch.Generator().manual_seed(seed)
    return {"x": torch.rand(4, 32, 32, 3, generator=gen),
            "y": torch.randint(0, 10, (4,), generator=gen)}


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


def test_a_resnet_and_its_optimizer_round_trip_bit_for_bit(tmp_path,
                                                           size_one):
    model = _small_resnet()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    for i in range(2):
        train_step(model, opt, _batch(i))
    path = str(tmp_path / "ckpt")
    ck.save(path, {"model": model.state_dict(), "opt": opt.state_dict(),
                   "step": 2})
    assert ck.exists(path) and not ck.exists(str(tmp_path / "other"))
    state = ck.restore(path)
    assert state["step"] == 2
    for k, v in model.state_dict().items():
        assert _bits(state["model"][k]) == _bits(v), k
    fresh = _small_resnet(seed=1)
    fresh_opt = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9)
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["opt"])
    live = train_step(model, opt, _batch(2))
    resumed = train_step(fresh, fresh_opt, _batch(2))
    assert _bits(live) == _bits(resumed)
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert _bits(a) == _bits(b), k


def test_like_places_casts_and_checks_the_structure(tmp_path, size_one):
    path = str(tmp_path / "ckpt")
    ck.save(path, _torch_state(3))
    like = {"w": torch.zeros(4, dtype=torch.float64),
            "nested": {"b": torch.zeros(2, 3), "i": torch.zeros(2)},
            "step": 0}
    got = ck.restore(path, like=like)
    assert got["w"].dtype == torch.float64 and got["step"] == 3
    assert got["nested"]["b"].dtype == torch.float32
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.float64) * 3)
    with pytest.raises(ValueError, match="expected a tensor of shape"):
        ck.restore(path, like={**like, "w": torch.zeros(5)})
    with pytest.raises(ValueError, match="stored keys"):
        ck.restore(path, like={"w": like["w"], "step": 0})


def test_restore_latest_skips_a_corrupt_newest(tmp_path, size_one,
                                               monkeypatch):
    base = str(tmp_path / "run")
    paths = [ck.save_rotating(base, _torch_state(s), keep=2, step=s)
             for s in (1, 2, 3)]
    assert [os.path.basename(p) for p in paths] == \
        ["run.00000001", "run.00000002", "run.00000003"]
    assert [seq for seq, _ in ck._list_snapshots(base)] == [3, 2]
    _damage(paths[-1], "flipped_byte")
    skipped = []
    monkeypatch.setattr(ck.log, "warning",
                        lambda msg, *a: skipped.append(msg % a))
    state = ck.restore_latest(base)
    assert state["step"] == 2
    assert len(skipped) == 1 and "00000003" in skipped[0] and \
        "payload CRC mismatch" in skipped[0]
    with pytest.raises(CheckpointNotFoundError, match="no checkpoint at"):
        ck.restore(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="keep must be >= 1"):
        ck.save_rotating(base, _torch_state(4), keep=0)


def test_restore_refuses_a_snapshot_that_fails_its_check(tmp_path, size_one):
    path = str(tmp_path / "ckpt")
    ck.save(path, _torch_state(1))
    _damage(path, "flipped_byte")
    with pytest.raises(HorovodInternalError,
                       match="failed integrity verification: payload CRC"):
        ck.restore(path)


# ---------------------------------------------------------------------------
# np=2 through the launcher, ending in the injected kill
# ---------------------------------------------------------------------------

_WORKER = '''
import json, os, sys
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ck
from horovod_tpu_torch.common.exceptions import (CheckpointNotFoundError,
                                                 HorovodInternalError)

out = sys.argv[1]
hvd.init(device="cpu")
rank = hvd.rank()
base = os.path.join(out, "run")
info = {}


def state(step):
    return {"w": torch.full((4,), float(step)), "step": step}


# Only rank 0's tree is saved.
for step in (1, 2):
    info[f"published.{step}"] = ck.save_rotating(
        base, state(step) if rank == 0 else state(-1), keep=5, step=step)
latest = ck.restore_latest(base, like={"w": torch.zeros(4, dtype=torch.float64),
                                       "step": 0})
first = ck.restore(info["published.1"])
info["latest"] = [latest["w"].tolist(), str(latest["w"].dtype),
                  latest["step"]]
info["first"] = [first["w"].tolist(), first["step"]]
for kind, call in (
        ("restore", lambda: ck.restore(os.path.join(out, "missing"))),
        ("restore_latest",
         lambda: ck.restore_latest(os.path.join(out, "nothing")))):
    try:
        call()
        info[f"not_found.{kind}"] = None
    except CheckpointNotFoundError as e:
        info[f"not_found.{kind}"] = str(e)
blocker = os.path.join(out, "blocker")
if rank == 0:
    with open(blocker, "w") as f:
        f.write("a file, not a directory")
try:
    ck.save(os.path.join(blocker, "ckpt"), state(9))
    info["io_error"] = None
except HorovodInternalError as e:
    info["io_error"] = str(e)
info["exists"] = [ck.exists(info["published.2"]),
                  ck.exists(os.path.join(out, "missing"))]
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(info, f)
print("WORKER_DONE", rank, flush=True)
# The third ckpt.save call on rank 0 exits between publish and manifest.
ck.save_rotating(base, state(3), keep=5, step=3)
print("SURVIVED", rank, flush=True)
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_np2")
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, HOROVOD_MESH_STARTUP_TIMEOUT="60",
               HOROVOD_FAULT_SPEC="ckpt.save:nth=3:action=exit,9")
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         sys.executable, str(script), str(out)],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        pytest.fail(f"np=2 job timed out after {JOB_TIMEOUT}s\n{stdout}\n"
                    f"{stderr}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    return {"code": proc.returncode, "stdout": stdout, "stderr": stderr,
            "out": out, "ranks": ranks}


def test_the_restored_state_is_rank_zeros_on_both_ranks(job):
    for info in job["ranks"]:
        assert info["latest"] == [[2.0] * 4, "torch.float64", 2]
        assert info["first"] == [[1.0] * 4, 1]
        assert info["published.2"].endswith("run.00000002")
    assert job["ranks"][0] == job["ranks"][1]


@pytest.mark.parametrize("kind", ["restore", "restore_latest"])
def test_a_missing_checkpoint_raises_on_both_ranks(job, kind):
    texts = [info[f"not_found.{kind}"] for info in job["ranks"]]
    assert texts[0] is not None and texts[0] == texts[1]
    assert texts[0].startswith("no checkpoint at" if kind == "restore"
                               else "no valid snapshot under")


def test_a_rank_zero_io_failure_raises_on_both_ranks(job):
    texts = [info["io_error"] for info in job["ranks"]]
    assert texts[0] == texts[1]
    assert texts[0].startswith("rank 0 checkpoint I/O failed: ")
    assert "NotADirectoryError" in texts[0] or "FileExistsError" in texts[0]


def test_exists_agrees_on_both_ranks(job):
    for info in job["ranks"]:
        assert info["exists"] == [True, False]


def test_the_injected_kill_ends_the_job_mid_save(job):
    assert job["code"] == 9, (job["stdout"], job["stderr"])
    assert "WORKER_DONE 0" in job["stdout"]
    assert "SURVIVED" not in job["stdout"]
    third = job["out"] / "run.00000003"
    assert third.is_dir()
    assert not Path(str(third) + ck.MANIFEST_SUFFIX).exists()


def test_restore_latest_skips_the_half_written_snapshot(job, size_one,
                                                        monkeypatch):
    assert not faults.ACTIVE
    skipped = []
    monkeypatch.setattr(ck.log, "warning",
                        lambda msg, *a: skipped.append(msg % a))
    state = ck.restore_latest(str(job["out"] / "run"))
    assert state["step"] == 2 and torch.equal(state["w"],
                                              torch.full((4,), 2.0))
    assert len(skipped) == 1
    assert "00000003" in skipped[0] and "no manifest" in skipped[0]
