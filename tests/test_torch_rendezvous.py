"""The port's rendezvous server, journal and driver recovery against the
JAX package's.

In process, on 127.0.0.1 with ports the kernel picks:

- the journal's frame codec byte for byte, and journals written by either
  package (seeded sets, deletes and batch groups, with compactions)
  replayed by the other to the same state;
- the port's journal torn at every offset of its last record and of a
  batch group (the longest prefix; a group whole or not at all), an
  aborted compaction, and the journal off;
- the port's ``HTTPStoreClient`` against the JAX ``RendezvousServer`` and
  the JAX client against the port's server, on one seeded op sequence
  with ``check``, ``delete`` and ``keys``: the same results as a
  ``MemoryStore`` of either package, with batching on and off (the per-op
  fallback); signatures and ``GET /metrics``;
- a restart that replays and serves keys, a server SIGKILLed and started
  again on its port over its journal, the external adapter's surface, and
  the server's ``RV_*`` and ``JR_*`` spans;
- both drivers' ``recover_steps`` and ``outage_recovery_steps`` on the
  same inputs, ``recover_from_store`` re-adopting the epoch and the
  leased workers (and doing nothing on a fresh store), a driver that
  rides out a restart of its external server without shedding a worker,
  which fails without the re-grace, and a driver whose store fails in the
  middle of an epoch change;
- both packages' ``control_path`` on the same trace files, and the clock
  offset estimated from either package's server.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import signal
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.core import timeline as jax_timeline
from horovod_tpu.elastic import driver as jax_driver
from horovod_tpu.runner import rendezvous as jax_rendezvous
from horovod_tpu.tools import control_path as jax_control_path
from horovod_tpu.transport import journal as jax_journal
from horovod_tpu.transport import store as jax_store
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.core import timeline
from horovod_tpu_torch.elastic import discovery, driver
from horovod_tpu_torch.runner import hosts
from horovod_tpu_torch.runner import rendezvous
from horovod_tpu_torch.tools import control_path
from horovod_tpu_torch.transport import journal
from horovod_tpu_torch.transport import store

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
SEEDS = range(6)


@pytest.fixture(autouse=True)
def _no_job_env(monkeypatch):
    for name in (env_mod.HOROVOD_SECRET_KEY, env_mod.HOROVOD_RENDEZVOUS_BATCH,
                 env_mod.HOROVOD_RENDEZVOUS_BATCH_MAX_OPS,
                 env_mod.HOROVOD_RENDEZVOUS_JOURNAL_DIR,
                 env_mod.HOROVOD_SERVER_TIMELINE):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

def _records(rng, n):
    out = []
    for _ in range(n):
        op = journal.OP_SET if rng.random() < 0.7 else journal.OP_DELETE
        key = f"scope{rng.integers(0, 3)}/k{rng.integers(0, 9)}"
        value = bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                   dtype=np.uint8)) \
            if op == journal.OP_SET else b""
        out.append((op, key, value))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_the_frame_codec_is_the_jax_bytes(seed):
    rng = np.random.default_rng(seed)
    recs = _records(rng, 8)
    for op, key, value in recs:
        ours = journal.encode_op(op, key, value)
        assert ours == jax_journal.encode_op(op, key, value)
        assert journal.pack_frame(ours) == jax_journal.pack_frame(ours)
        assert journal.decode_op(ours) == (op, key, value)
    group = journal.encode_group(recs)
    assert group == jax_journal.encode_group(recs)
    assert journal.decode_group(group) == recs
    blob = b"".join(journal.pack_frame(p) for p in
                    (b"a", group, b"")) + b"\x05torn"
    assert list(journal.iter_frames(blob)) == \
        list(jax_journal.iter_frames(blob))


def test_a_corrupt_frame_ends_the_valid_prefix():
    blob = bytearray(journal.pack_frame(b"one") + journal.pack_frame(b"two"))
    blob[-1] ^= 0xFF
    assert [p for _, p in journal.iter_frames(bytes(blob))] == [b"one"]
    huge = struct.pack("<QI", 2 ** 62, 0) + b"x" * 64
    assert list(journal.iter_frames(huge)) == []


def _mutate(stores, rng, mirror, n_ops):
    """The same seeded sets, deletes and batches on every store in
    ``stores``; ``mirror`` follows the expected state."""
    for _ in range(n_ops):
        scope = ["rank_and_size", "lease", "metrics"][int(rng.integers(0, 3))]
        key = f"k{int(rng.integers(0, 12))}"
        roll = rng.random()
        if roll < 0.2 and mirror:
            flat = sorted(mirror)[int(rng.integers(0, len(mirror)))]
            s, k = flat.split("/", 1)
            for st in stores:
                st.delete(s, k)
            mirror.pop(flat)
        elif roll < 0.35:
            value = f"b{int(rng.integers(0, 999))}".encode()
            ops = [("set", scope, key, value), ("get", scope, key),
                   ("delete", scope, "k0"), ("keys", scope)]
            results = [st.batch(ops) for st in stores]
            assert all(r == results[0] for r in results)
            mirror[f"{scope}/{key}"] = value
            mirror.pop(f"{scope}/k0", None)
        else:
            value = bytes(rng.integers(0, 256, int(rng.integers(0, 64)),
                                       dtype=np.uint8))
            for st in stores:
                st.set(scope, key, value)
            mirror[f"{scope}/{key}"] = value


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("seed", SEEDS)
def test_a_journal_written_by_either_package_replays_in_the_other(
        tmp_path, writer, seed):
    rng = np.random.default_rng(seed)
    every = [3, 7, 1000][seed % 3]
    mods = (store, jax_store) if writer == "port" else (jax_store, store)
    w = mods[0].DurableMemoryStore(str(tmp_path / "j"), fsync=False,
                                   snapshot_every=every)
    mirror = {}
    _mutate([w], rng, mirror, 120)
    w.close()
    files_before = sorted(os.listdir(tmp_path / "j"))
    r = mods[1].DurableMemoryStore(str(tmp_path / "j"), fsync=False)
    assert r._data == mirror
    r.close()
    assert sorted(os.listdir(tmp_path / "j")) == files_before


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_both_packages_write_the_same_journal_bytes(tmp_path, seed):
    rng = np.random.default_rng(seed)
    every = [3, 7, 1000][seed % 3]
    ours = store.DurableMemoryStore(str(tmp_path / "p"), fsync=False,
                                    snapshot_every=every)
    theirs = jax_store.DurableMemoryStore(str(tmp_path / "j"), fsync=False,
                                          snapshot_every=every)
    _mutate([ours, theirs], rng, {}, 80)
    ours.close()
    theirs.close()
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_a_torn_write_at_every_offset_recovers_the_longest_prefix(tmp_path):
    jdir = tmp_path / "j"
    st = store.DurableMemoryStore(str(jdir), fsync=False,
                                  snapshot_every=10 ** 9)
    st.set("s", "a", b"alpha")
    st.set("s", "b", b"beta")
    st.delete("s", "a")
    before = dict(st._data)
    st.set("s", "final", b"the-final-record-payload")
    st.close()
    blob = (jdir / "journal-00000000").read_bytes()
    final_start = [end for end, _ in journal.iter_frames(blob)][-2]
    for cut in range(final_start, len(blob)):
        case = tmp_path / f"cut{cut}"
        shutil.copytree(jdir, case)
        with open(case / "journal-00000000", "r+b") as f:
            f.truncate(cut)
        theirs = jax_store.DurableMemoryStore(str(case), fsync=False)
        assert theirs._data == before, cut
        theirs.close()
        shutil.rmtree(case)
        shutil.copytree(jdir, case)
        with open(case / "journal-00000000", "r+b") as f:
            f.truncate(cut)
        ours = store.DurableMemoryStore(str(case), fsync=False)
        assert ours._data == before, cut
        # The torn tail was cut off: an append extends the valid prefix.
        ours.set("s", "post", b"post")
        ours.close()
        again = store.DurableMemoryStore(str(case), fsync=False)
        assert again._data == {**before, "s/post": b"post"}, cut
        again.close()
        shutil.rmtree(case)


def test_a_batch_group_torn_at_every_offset_is_all_or_nothing(tmp_path):
    jdir = tmp_path / "j"
    st = store.DurableMemoryStore(str(jdir), fsync=False,
                                  snapshot_every=10 ** 9)
    st.set("s", "keep", b"keep-me")
    st.set("s", "doomed", b"delete-me")
    before = dict(st._data)
    results = st.batch([
        ("set", "s", "a", b"alpha"),
        ("set", "lease", "h0:0", b'{"renewals": 1}'),
        ("delete", "s", "doomed"),
        ("get", "s", "keep"),
        ("set", "s", "a", b"alpha-2"),
        ("keys", "s"),
    ])
    assert results == [True, True, True, b"keep-me", True, ["a", "keep"]]
    after = dict(st._data)
    st.close()
    blob = (jdir / "journal-00000000").read_bytes()
    group_start = [end for end, _ in journal.iter_frames(blob)][-2]
    seen = set()
    for cut in range(group_start, len(blob) + 1):
        case = tmp_path / f"cut{cut}"
        shutil.copytree(jdir, case)
        with open(case / "journal-00000000", "r+b") as f:
            f.truncate(cut)
        rec = store.DurableMemoryStore(str(case), fsync=False)
        assert rec._data in (before, after), cut
        seen.add("all" if rec._data == after else "none")
        rec.close()
        shutil.rmtree(case)
    assert seen == {"none", "all"}


def test_an_aborted_compaction_falls_back_a_generation(tmp_path):
    jdir = tmp_path / "j"
    st = store.DurableMemoryStore(str(jdir), fsync=False, snapshot_every=5)
    for i in range(8):
        st.set("s", f"k{i}", b"v%d" % i)
    expect = dict(st._data)
    st.close()
    assert (jdir / "snap-00000001").exists()
    (jdir / "snap-00000002").write_bytes(
        journal.pack_frame(journal.SNAP_MAGIC) + journal.pack_frame(
            journal.encode_op(journal.OP_SET, "s/k0", b"stale")))
    for mod in (store, jax_store):
        rec = mod.DurableMemoryStore(str(jdir), fsync=False)
        assert rec._data == expect
        rec.close()


def test_no_journal_dir_is_a_plain_memory_store(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    st = store.DurableMemoryStore(None)
    st.set("s", "k", b"v")
    assert st.get("s", "k") == b"v"
    assert st.pop("s", "k") == b"v" and st.pop("s", "k") is None
    st.close()
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# the server and the clients, across the packages
# ---------------------------------------------------------------------------

def _op_sequence(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        scope = f"s{int(rng.integers(0, 2))}"
        key = f"k{int(rng.integers(0, 5))}"
        roll = rng.random()
        if roll < 0.35:
            ops.append(("set", scope, key,
                        f"v{int(rng.integers(0, 99))}".encode()))
        elif roll < 0.55:
            ops.append(("get", scope, key))
        elif roll < 0.7:
            ops.append(("delete", scope, key))
        elif roll < 0.8:
            ops.append(("keys", scope))
        else:
            expect = None if rng.random() < 0.5 else \
                f"v{int(rng.integers(0, 99))}".encode()
            ops.append(("check", scope, key, expect))
    return ops


def _batches(ops, seed):
    rng = random.Random(seed)
    i = 0
    while i < len(ops):
        n = rng.randint(1, 6)
        yield ops[i:i + n]
        i += n


def _sorted_lists(results):
    return [sorted(r) if isinstance(r, list) else r for r in results]


def _start(pkg: str, **kwargs):
    mod = rendezvous if pkg == "port" else jax_rendezvous
    srv = mod.RendezvousServer("127.0.0.1", **kwargs)
    return srv, srv.start()


def _client(pkg: str, port: int):
    mod = store if pkg == "port" else jax_store
    return mod.HTTPStoreClient("127.0.0.1", port)


@pytest.mark.parametrize("batching", ["on", "off"])
@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"),
                                                   ("jax", "port"),
                                                   ("port", "port")])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_a_seeded_op_sequence_gives_the_same_results_across_packages(
        _no_job_env, client_pkg, server_pkg, batching, seed):
    _no_job_env.setenv(env_mod.HOROVOD_SECRET_KEY, "k" * 64)
    if batching == "off":
        _no_job_env.setenv(env_mod.HOROVOD_RENDEZVOUS_BATCH, "0")
    srv, port = _start(server_pkg, job_secret=b"k" * 64)
    _no_job_env.delenv(env_mod.HOROVOD_RENDEZVOUS_BATCH, raising=False)
    try:
        client = _client(client_pkg, port)
        reference = jax_store.MemoryStore()
        ours = store.MemoryStore()
        for chunk in _batches(_op_sequence(seed), seed):
            if batching == "on":
                want = reference.batch(chunk)
                assert ours.batch(chunk) == want, chunk
            else:
                # One request per op: no atomicity, so the ops before a
                # failed check have landed (the JAX base class's loop; a
                # MemoryStore lists keys unsorted, the server sorted).
                want = _sorted_lists(jax_store.Store.batch(reference, chunk))
                assert _sorted_lists(store.KVStore.batch(ours, chunk)) == \
                    want, chunk
            assert client.batch(chunk) == want, chunk
        assert client._batch_unsupported is (batching == "off")
        for scope in ("s0", "s1"):
            assert client.keys(scope) == sorted(reference.keys(scope))
    finally:
        srv.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"),
                                                   ("jax", "port")])
def test_a_request_signed_with_another_key_is_refused(
        _no_job_env, client_pkg, server_pkg):
    import urllib.error

    srv, port = _start(server_pkg, job_secret=b"k" * 64)
    try:
        _no_job_env.setenv(env_mod.HOROVOD_SECRET_KEY, "x" * 64)
        client = _client(client_pkg, port)
        with pytest.raises(urllib.error.HTTPError) as err:
            client.set("s", "k", b"v")
        assert err.value.code == 403
        with pytest.raises(urllib.error.HTTPError):
            client.batch([("get", "s", "k")])
    finally:
        srv.stop()


def test_get_metrics_answers_404_naming_a7():
    import urllib.error
    import urllib.request

    srv, port = _start("port")
    try:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with pytest.raises(urllib.error.HTTPError) as err:
            opener.open(f"http://127.0.0.1:{port}/metrics", timeout=5)
        assert err.value.code == 404
        assert b"ROADMAP A7" in err.value.read()
    finally:
        srv.stop()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_a_restart_replays_and_serves_keys(tmp_path, _no_job_env,
                                           server_pkg):
    _no_job_env.setenv(env_mod.HOROVOD_SECRET_KEY, "k" * 64)
    jdir = str(tmp_path / "j")
    srv, port = _start(server_pkg, job_secret=b"k" * 64, journal_dir=jdir)
    client = _client("port", port)
    client.set("rank_and_size", "localhost:0", b'{"rank": 0}')
    client.batch([("set", "lease", "localhost:0", b'{"renewals": 3}'),
                  ("set", "lease", "otherhost:0", b'{"renewals": 1}')])
    assert client.keys("lease") == ["localhost:0", "otherhost:0"]
    srv.stop()
    # The other package's server replays the same journal.
    other = "jax" if server_pkg == "port" else "port"
    srv2, port2 = _start(other, job_secret=b"k" * 64, journal_dir=jdir)
    try:
        client2 = _client(server_pkg, port2)
        assert client2.get("rank_and_size", "localhost:0") == b'{"rank": 0}'
        assert client2.keys("lease") == ["localhost:0", "otherhost:0"]
        assert client2.keys("empty") == []
    finally:
        srv2.stop()


def _serve(port: int, jdir: str, trace: str = "") -> subprocess.Popen:
    """The supervised server as its own process, on ``port``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.rendezvous",
         "--bind", "127.0.0.1", "--port", str(port), "--journal-dir", jdir]
        + (["--trace", trace] if trace else []),
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    line = proc.stdout.readline()
    assert line.startswith("rendezvous serving on port"), line
    return proc


def test_a_sigkilled_server_comes_back_on_its_port_with_its_state(tmp_path):
    jdir = str(tmp_path / "j")
    srv, port = _start("port")          # a free port
    srv.stop()
    proc = _serve(port, jdir)
    try:
        client = _client("port", port)
        client.batch([("set", "driver", "epoch", b"4"),
                      ("set", "lease", "a:0", b"1")])
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        with pytest.raises(OSError):
            client.get("driver", "epoch")
        proc = _serve(port, jdir)
        assert client.get("driver", "epoch") == b"4"
        assert client.keys("lease") == ["a:0"]
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_the_external_adapter_has_the_servers_surface(_no_job_env):
    _no_job_env.setenv(env_mod.HOROVOD_SECRET_KEY, "k" * 64)
    srv, port = _start("port", job_secret=b"k" * 64)
    try:
        ext = rendezvous.ExternalRendezvous("127.0.0.1", port)
        assert ext.port == port
        slot = {"hostname": "localhost", "rank": 0, "local_rank": 0,
                "cross_rank": 0, "size": 1, "local_size": 1,
                "cross_size": 1, "epoch": 0}
        assert ext.batch([("set", "rank_and_size", "localhost:0",
                           json.dumps(slot).encode()),
                          ("keys", "rank_and_size")]) == \
            [True, ["localhost:0"]]
        assert json.loads(ext.get("rank_and_size", "localhost:0")) == slot
        assert ext.keys("rank_and_size") == ["localhost:0"]
        assert srv.get("rank_and_size", "localhost:0") == \
            ext.get("rank_and_size", "localhost:0")
        ext.delete("rank_and_size", "localhost:0")
        assert srv.keys("rank_and_size") == []
        ext.stop()  # the supervisor's server stays up
        ext.set("s", "k", b"v")
        assert srv.get("s", "k") == b"v"
    finally:
        srv.stop()
    with pytest.raises(SystemExit, match="host:port"):
        rendezvous.ExternalRendezvous.from_env("7010")


def test_the_server_writes_its_request_and_journal_spans(tmp_path):
    jdir = str(tmp_path / "j")
    traces = [tmp_path / "first.json", tmp_path / "restarted.json"]
    srv, port = _start("port", journal_dir=jdir, trace_path=str(traces[0]))
    client = _client("port", port)
    client.set("s", "a", b"1")
    client.batch([("set", "s", "b", b"2"), ("get", "s", "a")])
    assert client.get("s", "a") == b"1"
    srv.stop()
    srv, port = _start("port", journal_dir=jdir, trace_path=str(traces[1]))
    srv.stop()
    names = []
    for trace in traces:
        events = json.loads(trace.read_text())
        assert {e["pid"] for e in events} == {timeline.SERVER_TRACE_PID}
        names.append([e["name"] for e in events if e.get("ph") == "X"])
    # Two durable writes (the set and the batch's group), each synced.
    assert names[0].count("JR_FSYNC") == 2
    assert {"RV_PUT", "RV_BATCH", "RV_GET"} <= set(names[0])
    assert names[1] == ["JR_REPLAY"]


# ---------------------------------------------------------------------------
# the driver's recovery
# ---------------------------------------------------------------------------

def _drive(gen, answer):
    """Run a driver generator, answering each step with ``answer(step)``;
    returns (steps, result)."""
    steps, resp = [], None
    while True:
        try:
            step = gen.send(resp)
        except StopIteration as fin:
            return steps, fin.value
        steps.append(step)
        resp = answer(step)


@pytest.mark.parametrize("seed", SEEDS)
def test_recover_steps_match_jax(seed):
    rng = np.random.default_rng(seed)
    epoch = int(rng.integers(0, 6))
    leased = sorted({f"h{int(rng.integers(0, 6))}:{int(rng.integers(0, 2))}"
                     for _ in range(5)})
    fetched = []
    for identity in leased:
        lease = None if rng.random() < 0.2 else b'{"renewals": 2}'
        if rng.random() < 0.15:
            slot = None
        elif rng.random() < 0.1:
            slot = b"not json"
        else:
            slot = json.dumps({
                "hostname": identity.split(":")[0],
                "rank": int(rng.integers(-1, 3)),
                "local_rank": int(identity.split(":")[1]), "cross_rank": 0,
                "size": 3, "local_size": 1, "cross_size": 3,
                "epoch": epoch - int(rng.integers(0, 2))}).encode()
        fetched += [lease, slot]
    fresh = seed % 3 == 0

    def answer(step):
        if step[0] != driver.STEP_TXN:
            return 100.0 if step[0] == driver.STEP_CLOCK else None
        if step[2] == "recover_epoch":
            return [None if fresh else str(epoch).encode()]
        if step[2] == "recover_lease_keys":
            return [leased]
        return fetched

    ours = _drive(driver.recover_steps(7.5), answer)
    assert ours == _drive(jax_driver.recover_steps(7.5), answer)
    if fresh:
        assert ours[1] is None
    else:
        assert ours[0][-1] == (driver.STEP_GRACE, 107.5)


def test_outage_recovery_steps_match_jax():
    answer = lambda step: 50.0 if step[0] == driver.STEP_CLOCK else None  # noqa: E731
    ours = _drive(driver.outage_recovery_steps(15.0), answer)
    assert ours == _drive(jax_driver.outage_recovery_steps(15.0), answer)
    assert ours[0] == [(driver.STEP_CLOCK,), (driver.STEP_GRACE, 65.0)]


def _driver_on(server, hosts_spec, **kwargs):
    return driver.ElasticDriver(
        server, discovery.HostManager(discovery.FixedHosts(
            hosts.parse_hosts(hosts_spec))), min_np=1, **kwargs)


def test_recover_from_store_readopts_the_epoch_and_leased_workers(tmp_path):
    jdir = str(tmp_path / "j")
    spec = "localhost:1,127.0.0.1:1"
    srv, _ = _start("port", journal_dir=jdir)
    first = _driver_on(srv, spec, lease_timeout=60.0)
    spawned = []
    first._create_worker = lambda slot, epoch: spawned.append(epoch)
    first.wait_for_available_slots()
    assert first._rendezvous_epoch(initial=True)
    first.hosts.blacklist("127.0.0.1")
    first.hosts.update_available_hosts()
    first._rendezvous_epoch()
    assert first.epoch == 1
    srv.set("lease", "localhost:0", b'{"renewals": 4}')
    srv.set("lease", "127.0.0.1:0", b'{"renewals": 2}')   # rank -1 now
    srv.stop()

    srv, _ = _start("port", journal_dir=jdir)
    try:
        again = _driver_on(srv, "localhost:1", lease_timeout=60.0)
        assert again.recover_from_store() is True
        assert again.epoch == 1 and again._recovered_epoch == 1
        assert set(again._known_identities) == {"localhost:0"}
        assert again._lease_seen["localhost:0"][0] == b'{"renewals": 4}'
        assert again._lease_grace_until > time.monotonic() + 50
        spawned2 = []
        again._create_worker = lambda slot, epoch: spawned2.append(epoch)
        assert again._rendezvous_epoch(initial=True)
        assert spawned2 == [] and again.epoch == 1
        # A publish of an earlier incarnation in between fails the fence.
        srv.set("driver", "epoch", b"2")
        assert again._rendezvous_epoch(initial=True) is False
    finally:
        srv.stop()


def test_recover_from_store_on_a_fresh_store_does_nothing():
    srv, _ = _start("port")
    try:
        d = _driver_on(srv, "localhost:1")
        assert d.recover_from_store() is False
        assert d.epoch == 0 and d._recovered_epoch is None
    finally:
        srv.stop()


def test_a_driver_rides_out_a_restart_of_its_external_server(tmp_path,
                                                             monkeypatch):
    """The supervised server is SIGKILLed, stays down longer than the lease
    timeout and comes back on its port over its journal: its replayed
    leases are older than the timeout, and only the re-grace keeps the
    driver from shedding both workers."""
    clock = [1000.0]
    monkeypatch.setattr(driver.time, "monotonic", lambda: clock[0])
    jdir = str(tmp_path / "j")
    srv, port = _start("port")          # a free port
    srv.stop()
    proc = _serve(port, jdir)
    try:
        workers = _client("port", port)
        d = driver.ElasticDriver(
            rendezvous.ExternalRendezvous("127.0.0.1", port),
            discovery.HostManager(discovery.FixedHosts(
                hosts.parse_hosts("ra:1,rb:1"))), min_np=1,
            lease_timeout=3.0)
        d._create_worker = lambda slot, epoch: None
        d.wait_for_available_slots()
        assert d._rendezvous_epoch(initial=True)

        def tick(renewing, n, step=1.0):
            for ident in renewing:
                workers.set("lease", ident,
                            json.dumps({"renewals": n}).encode())
            d._tick()
            clock[0] += step

        for n in (1, 2):
            tick(("ra:0", "rb:0"), n)
        proc.kill()
        proc.wait(timeout=10)
        for _ in range(5):                   # ten seconds without a store
            tick((), 0, step=2.0)
        assert d._store_outage_since is not None and d.epoch == 0
        proc = _serve(port, jdir)
        tick((), 0)                          # the replayed, old leases
        assert d.epoch == 0 and d._store_outage_since is None
        for n in (3, 4, 5):                  # the workers renew again
            tick(("ra:0", "rb:0"), n)
        assert d.epoch == 0
        assert set(d._known_identities) == {"ra:0", "rb:0"}
        for n in range(6, 11):               # rb stops renewing
            tick(("ra:0",), n)
        assert d.epoch == 1                  # expiry still works
    finally:
        proc.kill()
        proc.wait(timeout=10)


class _FlakyStore(store.MemoryStore):
    """A store whose next publish of the driver's epoch fails as a dead
    server's does."""

    fail = False

    def batch(self, ops):
        if self.fail and ("set", "driver", "epoch") in [op[:3] for op in ops]:
            self.fail = False
            raise ConnectionRefusedError("the server is down")
        return super().batch(ops)


class _Hosts:
    def __init__(self, hosts):
        self.hosts = hosts

    def find_available_hosts_and_slots(self):
        return dict(self.hosts)


def test_a_store_error_mid_change_makes_the_change_again():
    """The JAX driver's discovery thread dies here; the port's enters its
    outage mode and, when the store answers, publishes the change at a
    newer epoch."""
    st = _FlakyStore()
    disc = _Hosts({"fa": 1, "fb": 1})
    d = driver.ElasticDriver(st, discovery.HostManager(disc), min_np=1)
    d.start(lambda slot, epoch: None)
    try:
        st.fail = True
        disc.hosts = {"fa": 1}
        deadline = time.monotonic() + 20
        while st.get("driver", "epoch") != b"2" and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert st.get("driver", "epoch") == b"2" and not st.fail
        assert d._discovery_thread.is_alive()
        table = {i: json.loads(st.get("rank_and_size", i))
                 for i in ("fa:0", "fb:0")}
        assert table["fa:0"]["epoch"] == 2 and table["fb:0"]["rank"] == -1
    finally:
        d.stop()
        d._discovery_thread.join(timeout=10)


# ---------------------------------------------------------------------------
# control_path and the clock
# ---------------------------------------------------------------------------

def _synthetic_traces(tmp_path, seed):
    """A server, a driver and a worker trace with seeded control spans and
    CHURN_EVENT windows, each with its clock_sync record."""
    rng = np.random.default_rng(seed)
    base = 1_700_000_000_000_000_000
    files = []
    for pid, names in ((timeline.SERVER_TRACE_PID,
                        ["RV_PUT", "RV_GET", "RV_BATCH", "RV_LOCK_WAIT",
                         "JR_FSYNC"]),
                       (timeline.DRIVER_TRACE_PID,
                        ["RVC_BATCH", "DRV_SPAWN", "DRV_WAIT", "RVC_GET"]),
                       (0, ["RVC_SET", "RVC_GET"])):
        events = [{"name": "clock_sync", "ph": "M", "pid": pid,
                   "args": {"wall_base_ns": base + int(rng.integers(0, 5e6)),
                            "server_offset_ns": int(rng.integers(-2e5, 2e5)),
                            "rank": pid}}]
        t = 0.0
        for _ in range(60):
            t += float(rng.integers(1, 400))
            events.append({"name": names[int(rng.integers(0, len(names)))],
                           "ph": "X", "pid": pid, "tid": 1, "ts": t,
                           "dur": float(rng.integers(5, 900))})
        if pid == timeline.DRIVER_TRACE_PID:
            for epoch in (1, 2, 3):
                b = float(rng.integers(0, int(t)))
                events.append({"name": "CHURN_EVENT", "ph": "X", "pid": pid,
                               "tid": 2, "ts": b,
                               "dur": float(rng.integers(500, 5000)),
                               "args": {"epoch": epoch, "cause": "host_change"}})
        path = tmp_path / f"trace{pid}.json"
        path.write_text(json.dumps(events))
        files.append(str(path))
    return files


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_control_path_matches_jax_on_the_same_traces(tmp_path, seed, capsys):
    files = _synthetic_traces(tmp_path, seed)
    assert control_path.main(files + ["--json", str(tmp_path / "p.json")]) \
        == 0
    ours = capsys.readouterr().out
    assert jax_control_path.main(files + ["--json",
                                          str(tmp_path / "j.json")]) == 0
    assert ours == capsys.readouterr().out
    doc = json.loads((tmp_path / "p.json").read_text())
    assert doc == json.loads((tmp_path / "j.json").read_text())
    assert doc["event_count"] == 3
    for e in doc["events"]:
        covered = sum(e["phases_us"].values())
        assert covered == pytest.approx(e["coverage"] * e["duration_us"],
                                        rel=0.01, abs=1.0)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_the_clock_offset_is_estimated_from_either_server(_no_job_env,
                                                          server_pkg):
    srv, port = _start(server_pkg)
    try:
        _no_job_env.setenv(env_mod.HOROVOD_RENDEZVOUS_ADDR, "127.0.0.1")
        _no_job_env.setenv(env_mod.HOROVOD_RENDEZVOUS_PORT, str(port))
        for estimate in (timeline.estimate_server_clock_offset_ns,
                         jax_timeline.estimate_server_clock_offset_ns):
            offset = estimate()
            # One host, one clock: the offset is the round trip's noise.
            assert isinstance(offset, int) and abs(offset) < 50_000_000
    finally:
        srv.stop()
    _no_job_env.setenv(env_mod.HOROVOD_RENDEZVOUS_PORT, str(port))
    assert timeline.estimate_server_clock_offset_ns() is None
