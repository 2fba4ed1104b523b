"""The port's cross-rank plumbing against the JAX package: the wire encoding,
the rendezvous store, the host/slot layout, the launcher, the data-plane
knob and the concurrent kernel build.

Wire frames are built from numpy seeds in both packages and must be the
same bytes.  The launcher is driven in this process with ``sh`` workers
(no Python worker starts here; the training jobs are in
``test_torch_controller.py``).
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest

from horovod_tpu.core import messages as jax_messages
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.common.exceptions import TruncatedFrameError
from horovod_tpu_torch.core import messages
from horovod_tpu_torch.kernels import build
from horovod_tpu_torch.runner import hosts, launch
from horovod_tpu_torch.transport.store import Store, StoreServer

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

_DTYPES = ["UINT8", "INT8", "INT32", "INT64", "FLOAT16", "FLOAT32",
           "FLOAT64", "BFLOAT16"]
_REQUEST_TYPES = ["ALLREDUCE", "BROADCAST", "ADASUM", "BARRIER"]


def _request_fields(rng: np.random.RandomState, rank: int) -> dict:
    ndim = rng.randint(0, 4)
    return dict(
        request_rank=rank,
        request_type=_REQUEST_TYPES[rng.randint(len(_REQUEST_TYPES))],
        tensor_name=f"grad.{rng.randint(1000)}.é{rng.randint(9)}",
        tensor_type=_DTYPES[rng.randint(len(_DTYPES))],
        tensor_shape=[int(d) for d in rng.randint(1, 300, ndim)],
        root_rank=int(rng.randint(-1, 4)),
        device=int(rng.randint(-1, 2)),
        group_id=int(rng.randint(-1, 3)),
        prescale_factor=float(rng.choice([1.0, 0.5, rng.rand()])),
        postscale_factor=float(rng.choice([1.0, 0.25, rng.rand()])),
        splits=[int(d) for d in rng.randint(0, 9, rng.randint(0, 3))])


def _request(mod, fields: dict):
    return mod.Request(**{**fields,
                          "request_type": mod.RequestType[fields["request_type"]],
                          "tensor_type": mod.DataType[fields["tensor_type"]]})


def _response_fields(rng: np.random.RandomState) -> dict:
    n = rng.randint(1, 5)
    error = rng.rand() < 0.3
    return dict(
        response_type="ERROR" if error else
        ["ALLREDUCE", "BROADCAST", "ADASUM"][rng.randint(3)],
        tensor_names=[f"t{rng.randint(100)}" for _ in range(n)],
        tensor_type=_DTYPES[rng.randint(len(_DTYPES))],
        tensor_sizes=[int(d) for d in rng.randint(1, 10**6, n)],
        error_message="Mismatched data types for t1." if error else "",
        devices=sorted({int(d) for d in rng.randint(-1, 2, 2)}),
        prescale_factor=float(rng.rand()),
        postscale_factor=float(rng.rand()),
        last_joined_rank=-1)


def _response(mod, fields: dict):
    return mod.Response(**{
        **fields, "response_type": mod.ResponseType[fields["response_type"]],
        "tensor_type": mod.DataType[fields["tensor_type"]]})


@pytest.mark.parametrize("seed", range(8))
def test_request_list_bytes_match_jax(seed):
    rng = np.random.RandomState(seed)
    fields = [_request_fields(rng, rank=int(rng.randint(4)))
              for _ in range(rng.randint(0, 6))]
    shutdown = bool(rng.rand() < 0.5)
    ours = messages.RequestList([_request(messages, f) for f in fields],
                                shutdown)
    theirs = jax_messages.RequestList(
        [_request(jax_messages, f) for f in fields], shutdown)
    data = ours.to_bytes()
    assert data == theirs.to_bytes()
    assert messages.RequestList.from_bytes(data) == ours
    assert jax_messages.RequestList.from_bytes(data) == theirs


@pytest.mark.parametrize("seed", range(8))
def test_response_list_bytes_match_jax(seed):
    rng = np.random.RandomState(100 + seed)
    fields = [_response_fields(rng) for _ in range(rng.randint(0, 6))]
    shutdown = bool(rng.rand() < 0.5)
    ours = messages.ResponseList([_response(messages, f) for f in fields],
                                 shutdown)
    theirs = jax_messages.ResponseList(
        [_response(jax_messages, f) for f in fields], shutdown)
    data = ours.to_bytes()
    assert data == theirs.to_bytes()
    assert messages.ResponseList.from_bytes(data) == ours
    assert jax_messages.ResponseList.from_bytes(data).responses == \
        theirs.responses


@pytest.mark.parametrize("frame", [
    jax_messages.ResponseList(tuned_params=(1 << 20, 2.0)),
])
def test_frames_with_response_cache_fields_are_refused(frame):
    """The port has no autotuning: a frame that carries tuned parameters is
    an error, not silently dropped state."""
    with pytest.raises(ValueError, match="autotun"):
        messages.ResponseList.from_bytes(frame.to_bytes())


@pytest.mark.parametrize("frame", [
    jax_messages.RequestList(cache_hits=[3]),
    jax_messages.RequestList(cache_mask=b"\x01"),
    jax_messages.ResponseList(evicted_bits=[1]),
])
def test_frames_with_response_cache_fields_come_through(frame):
    """The JAX frames that the port refused before it had a response cache
    decode with their cache fields, and encode to the same bytes."""
    data = frame.to_bytes()
    if isinstance(frame, jax_messages.RequestList):
        ours = messages.RequestList.from_bytes(data)
        assert (ours.cache_hits, ours.cache_mask) == (frame.cache_hits,
                                                      frame.cache_mask)
    else:
        ours = messages.ResponseList.from_bytes(data)
        assert ours.evicted_bits == frame.evicted_bits
    assert ours.to_bytes() == data


def test_truncated_and_foreign_frames_raise():
    data = messages.RequestList([messages.Request(tensor_name="abc")]
                                ).to_bytes()
    for cut in (3, 9, len(data) - 1):
        with pytest.raises(TruncatedFrameError, match="truncated"):
            messages.RequestList.from_bytes(data[:cut])
    with pytest.raises(ValueError, match="magic"):
        messages.ResponseList.from_bytes(b"\0" * 16)


# ---------------------------------------------------------------------------
# the rendezvous store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store_server():
    server = StoreServer(local_only=True)
    yield server
    server.close()


def test_store_set_get_wait_by_scope(store_server):
    client = Store.connect("127.0.0.1", store_server.port, timeout=10)
    assert client.get("scope", "k") is None
    client.set("scope", "k", b"v1")
    store_server.store.set("other", "k", b"v2")
    assert store_server.store.get("scope", "k") == b"v1"
    assert client.get("other", "k") == b"v2"
    # From another client: a TCPStore client is blocked while it waits.
    threading.Timer(0.2, store_server.store.set, ("late", "x", b"3")).start()
    assert client.wait("late", ["x"], timeout=10) == {"x": b"3"}


def test_store_wait_times_out_naming_the_missing_keys(store_server):
    client = Store.connect("127.0.0.1", store_server.port, timeout=10)
    client.set("w", "here", b"1")
    with pytest.raises(TimeoutError, match=r"\['gone'\].*'w'"):
        client.wait("w", ["here", "gone"], timeout=0.3)


def test_group_stores_are_scoped_by_name_and_epoch(store_server):
    a = store_server.store.group_store("control", 0)
    b = store_server.store.group_store("control", 1)
    a.set("rank0", "x")
    b.set("rank0", "y")
    assert a.get("rank0") == b"x" and b.get("rank0") == b"y"
    # A group's keys are the store's scope "<name>.<epoch>".
    assert store_server.store.get("control.1", "rank0") == b"y"


# ---------------------------------------------------------------------------
# hosts and slots
# ---------------------------------------------------------------------------

_LAYOUTS = [("localhost:2", 2), ("localhost:3", 3), ("h1:4,h2:4", 8),
            ("h1:4,h2:2", 5), ("h1:1,h2:3,h3:2", 6), ("a,b:2", 3)]


@pytest.mark.parametrize("spec,np_", _LAYOUTS)
def test_host_assignments_match_jax(spec, np_):
    ours = hosts.get_host_assignments(hosts.parse_hosts(spec), np_)
    theirs = jax_hosts.get_host_assignments(jax_hosts.parse_hosts(spec), np_)
    assert [vars(s) for s in ours] == [vars(s) for s in theirs]
    assert [s.to_env() for s in ours] == [s.to_env() for s in theirs]


def test_too_few_slots_raise_like_jax():
    with pytest.raises(ValueError) as ours:
        hosts.get_host_assignments(hosts.parse_hosts("h1:2"), 3)
    with pytest.raises(ValueError) as theirs:
        jax_hosts.get_host_assignments(jax_hosts.parse_hosts("h1:2"), 3)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec,np_", _LAYOUTS[:4])
def test_slot_env_matches_jax_for_the_keys_both_set(spec, np_):
    for ours, theirs in zip(
            hosts.get_host_assignments(hosts.parse_hosts(spec), np_),
            jax_hosts.get_host_assignments(jax_hosts.parse_hosts(spec), np_)):
        a = launch._slot_env(ours, "10.0.0.1", 4321,
                             {env_mod.HOROVOD_FUSION_THRESHOLD: "1024"})
        b = jax_launch._slot_env(theirs, "10.0.0.1", 4321,
                                 {env_mod.HOROVOD_FUSION_THRESHOLD: "1024"},
                                 tpu_chip_binding=False)
        keys = [k for k in a if k.startswith("HOROVOD_") or k == "PYTHONPATH"]
        assert env_mod.HOROVOD_RENDEZVOUS_PORT in keys
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}


def test_remote_slot_command_line():
    slot = hosts.SlotInfo("node7", 5, 1, 2, 8, 4, 2)
    env = {**slot.to_env(), env_mod.HOROVOD_RENDEZVOUS_ADDR: "10.0.0.1",
           "PYTHONPATH": "/src", "PATH": "/bin", "HOME": "/home/u",
           "SECRET_THING": "x y"}
    cmd = launch._ssh_command(slot, ["python", "train.py", "--lr", "0.1 2"],
                              env)
    assert cmd[:4] == ["ssh", "-o", "StrictHostKeyChecking=no", "node7"]
    assert cmd[4] == (
        f"cd {os.getcwd()} && env HOROVOD_HOSTNAME=node7 HOROVOD_RANK=5 "
        "HOROVOD_SIZE=8 HOROVOD_LOCAL_RANK=1 HOROVOD_LOCAL_SIZE=4 "
        "HOROVOD_CROSS_RANK=2 HOROVOD_CROSS_SIZE=2 "
        "HOROVOD_GLOO_RENDEZVOUS_ADDR=10.0.0.1 PYTHONPATH=/src PATH=/bin "
        "python train.py --lr '0.1 2'")
    assert not launch._is_local("node7") and launch._is_local("127.0.0.3")


# ---------------------------------------------------------------------------
# the launcher, with sh workers
# ---------------------------------------------------------------------------

def _launch(np_: int, script: str, *flags: str) -> int:
    args = launch.build_parser().parse_args(
        ["-np", str(np_), *flags, "sh", "-c", script])
    return launch.launch_job(args, args.command)


def test_launcher_prefixes_output_and_exports_the_slot(capfd):
    code = _launch(2, 'echo "hi $HOROVOD_RANK/$HOROVOD_SIZE '
                   '$HOROVOD_GLOO_RENDEZVOUS_ADDR $HOROVOD_DATA_PLANE"; '
                   'echo oops >&2', "--data-plane", "nccl", "--verbose")
    out, err = capfd.readouterr()
    assert code == 0
    for r in (0, 1):
        assert f"[{r}]<stdout>: hi {r}/2 127.0.0.1 nccl" in out
        assert f"[{r}]<stderr>: oops" in err


def test_launcher_ends_the_job_with_the_failing_rank_code(capfd):
    t0 = time.monotonic()
    code = _launch(3, 'if [ "$HOROVOD_RANK" = 1 ]; then exit 7; fi; '
                   'exec sleep 60')
    assert code == 7
    assert time.monotonic() - t0 < 20, "the other ranks were not stopped"


def test_launcher_start_timeout_aborts_ranks_that_never_check_in(capfd):
    t0 = time.monotonic()
    code = _launch(2, "exec sleep 60", "--start-timeout", "1")
    _, err = capfd.readouterr()
    assert code == 1
    assert "ranks [0, 1] failed to start within --start-timeout=1s" in err
    assert time.monotonic() - t0 < 20


def test_launcher_without_a_command_refuses():
    assert launch.run_commandline(["-np", "2"]) == 2


# ---------------------------------------------------------------------------
# the data-plane knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,plane", [
    (None, "cpu"), ("", "cpu"), ("cpu", "cpu"), ("TCP", "cpu"),
    ("nccl", "nccl"), (" NCCL ", "nccl")])
def test_data_plane_values(monkeypatch, value, plane):
    if value is None:
        monkeypatch.delenv(env_mod.HOROVOD_DATA_PLANE, raising=False)
    else:
        monkeypatch.setenv(env_mod.HOROVOD_DATA_PLANE, value)
    assert env_mod.data_plane() == plane


@pytest.mark.parametrize("value", ["auto", "xla", "gpu", "nccl2"])
def test_data_plane_refuses_other_values_naming_the_two(monkeypatch, value):
    """The JAX package's ``auto`` falls back silently; here it raises."""
    monkeypatch.setenv(env_mod.HOROVOD_DATA_PLANE, value)
    with pytest.raises(ValueError, match="'cpu'.*'nccl'"):
        env_mod.data_plane()


# ---------------------------------------------------------------------------
# the kernel build, from two threads at once
# ---------------------------------------------------------------------------

_FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write("build\\n")
with open(out, "wb") as f:
    for _ in range(5):
        f.write(b"x" * 1000)
        f.flush()
        time.sleep(0.05)
"""


def test_concurrent_first_builds_compile_once(tmp_path, monkeypatch):
    """Two ranks reach a kernel's first use at once: one compiles, the other
    waits for the lock and finds the whole library."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    paths, sizes = [], []

    def first_use():
        path = build._compile("k")
        paths.append(path)
        sizes.append(path.stat().st_size)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert log.read_text() == "build\n"
    assert len(paths) == 2 and paths[0] == paths[1] == build.library_path("k")
    assert sizes == [5000, 5000]
    assert not list((tmp_path / "_build").glob("*.tmp"))
