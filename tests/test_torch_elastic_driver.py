"""The elastic driver of the PyTorch port against the JAX package's.

- The driver's pure judgment generators (``pending_reset_reasons``,
  ``parse_demotion_reports``, ``decide_cause``, ``tick_read_steps``,
  ``scan_lease_steps``, ``tick_judgment_steps``, ``reshard_plan``,
  ``reshard_commit_steps``) of ``horovod_tpu/elastic/driver.py`` and of
  ``horovod_tpu_torch/elastic/driver.py``, driven with the same seeded
  scenarios (tables, leases, acks, reset requests and demotion reports
  built with numpy from a seed) and the same values sent back in: the
  yielded steps and the returned records must be equal (exact).
- ``HostManager`` over the same sequence of host sets with the clock
  patched, ``WorkerStateRegistry``, the worker-post payloads and the
  notify signature, byte for byte.
- The rendezvous client's ``batch`` against the JAX ``MemoryStore``'s
  semantics, and the ``store.put``, ``rendezvous.get``,
  ``store.get_serve`` and ``driver.tick`` fault sites, on the rendezvous
  client and on the process groups' ``TCPStore`` client.
- Both packages' ``ElasticDriver`` in process, on the same discovery
  sequence, spawning nothing: the same slot tables and epochs.
- The launcher's elastic flags, its refusal of TPU-VM discovery, its
  attachment to an external server, and one module-scoped job in which
  every rank dies: the launcher must exit non-zero promptly.

The in-process drivers and the worker-side client run against the port's
rendezvous server in this process (``runner/rendezvous.py``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.common import secret as jax_secret
from horovod_tpu.elastic import discovery as jax_discovery
from horovod_tpu.elastic import driver as jax_driver
from horovod_tpu.elastic import registration as jax_registration
from horovod_tpu.elastic import rendezvous_client as jax_rc
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.transport.store import MemoryStore as JaxMemoryStore
from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common import secret
from horovod_tpu_torch.common.exceptions import (
    FaultInjectedError,
    HorovodInternalError,
)
from horovod_tpu_torch.elastic import discovery, driver, registration
from horovod_tpu_torch.elastic import rendezvous_client as rc
from horovod_tpu_torch.runner import hosts
from horovod_tpu_torch.runner import launch
from horovod_tpu_torch.runner.rendezvous import RendezvousServer
from horovod_tpu_torch.transport.store import (
    HTTPStoreClient,
    Store,
    StoreServer,
)

from .torch_port import one_torch_thread  # noqa: F401  (autouse)
from .torch_port import run_job

REPO = Path(__file__).resolve().parent.parent
SEEDS = range(12)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------------------
# seeded scenarios
# ---------------------------------------------------------------------------

def _identities(rng, n=None):
    n = int(rng.integers(1, 6)) if n is None else n
    return [f"h{int(rng.integers(0, 4))}:{i}" for i in range(n)]


def _request_raw(rng, epoch):
    kind = int(rng.integers(0, 5))
    if kind == 0:
        return None
    if kind == 1:
        return b"{not json"
    if kind == 2:
        return json.dumps([1, 2]).encode()
    e = epoch + int(rng.integers(-1, 2))
    return json.dumps({"epoch": e, "reason": f"r{int(rng.integers(9))}"}
                      ).encode()


def _report_raw(rng, epoch):
    kind = int(rng.integers(0, 5))
    if kind == 0:
        return None
    if kind == 1:
        return b"\xff\xfe"
    rank = int(rng.integers(0, 4)) if kind != 2 else "1"
    rep = {"epoch": epoch + int(rng.integers(-1, 2)), "rank": rank,
           "hostname": f"h{int(rng.integers(0, 4))}" if rng.random() < .7
           else None, "ewma": float(rng.random()), "threshold": 0.5,
           "cycles": 3, "posted_unix": 1000.0}
    return json.dumps(rep).encode()


def _drive(gen, answer):
    """Every step a generator yields, answered by ``answer(step)``; returns
    (steps, return value)."""
    steps, resp = [], None
    while True:
        try:
            step = gen.send(resp)
        except StopIteration as fin:
            return steps, fin.value
        steps.append(step)
        resp = answer(step)


@pytest.mark.parametrize("seed", SEEDS)
def test_pending_reset_reasons_match_jax(seed):
    rng = np.random.default_rng(seed)
    epoch = int(rng.integers(0, 5))
    raws = {i: _request_raw(rng, epoch) for i in _identities(rng)}
    assert driver.pending_reset_reasons(raws, epoch) == \
        jax_driver.pending_reset_reasons(raws, epoch)


@pytest.mark.parametrize("seed", SEEDS)
def test_parse_demotion_reports_match_jax(seed):
    rng = np.random.default_rng(seed)
    epoch = int(rng.integers(0, 5))
    raws = {i: _report_raw(rng, epoch) for i in _identities(rng)}
    assert driver.parse_demotion_reports(raws, epoch) == \
        jax_driver.parse_demotion_reports(raws, epoch)


@pytest.mark.parametrize("bits", range(16))
def test_decide_cause_matches_jax(bits):
    args = [bool(bits & (1 << k)) for k in range(4)]
    assert driver.decide_cause(*args) == jax_driver.decide_cause(*args)


@pytest.mark.parametrize("seed", SEEDS)
def test_tick_read_steps_match_jax(seed):
    rng = np.random.default_rng(seed)
    epoch = int(rng.integers(0, 4))
    slot_ids = _identities(rng)
    removed = set(_identities(rng, 2)) - set(slot_ids)
    exited = {i for i in slot_ids + sorted(removed) if rng.random() < 0.3}
    await_ack = [None, True, False][int(rng.integers(0, 3))]

    def answer(step):
        return [None if rng.random() < 0.3 else
                str(int(rng.integers(0, 9))).encode() for _ in step[1]]

    state = rng.bit_generator.state
    ours = _drive(driver.tick_read_steps(epoch, await_ack, slot_ids,
                                         removed, exited), answer)
    rng.bit_generator.state = state
    theirs = _drive(jax_driver.tick_read_steps(epoch, await_ack, slot_ids,
                                               removed, exited), answer)
    assert ours == theirs


def _lease_scenario(rng):
    ids = _identities(rng)
    raws = {i: None if rng.random() < 0.2 else
            f"lease-{int(rng.integers(0, 3))}".encode() for i in ids}
    seen = {i: (f"lease-{int(rng.integers(0, 3))}".encode(),
                float(rng.integers(0, 30)))
            for i in ids + ["gone:0"] if rng.random() < 0.6}
    return raws, seen, float(rng.integers(0, 40)), 15.0


@pytest.mark.parametrize("seed", SEEDS)
def test_scan_lease_steps_match_jax(seed):
    rng = np.random.default_rng(seed)
    raws, seen, grace, timeout = _lease_scenario(rng)
    now = float(rng.integers(10, 60))
    out = []
    for mod in (driver, jax_driver):
        mine = dict(seen)
        steps, ret = _drive(mod.scan_lease_steps(raws, mine, grace, timeout),
                            lambda step: now)
        out.append((steps, ret, mine))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_tick_judgment_steps_match_jax(seed):
    rng = np.random.default_rng(seed)
    epoch = int(rng.integers(0, 4))
    slots = _identities(rng)
    known = [i for i in slots if rng.random() < 0.8]
    raws, seen, grace, timeout = _lease_scenario(rng)
    fetched = {"reset": {i: _request_raw(rng, epoch) for i in slots},
               "demotion": {i: _report_raw(rng, epoch) for i in slots},
               "lease": raws, "epoch_ack": None}
    rank_to_host = {r: i.split(":")[0] for r, i in enumerate(slots)
                    if rng.random() < 0.7}
    answers = {"clock": float(rng.integers(10, 60)),
               "poll": (bool(rng.random() < .5), bool(rng.random() < .5)),
               "gates": {g: bool(rng.random() < .2)
                         for g in ("success", "reset_limit", "capacity")}}

    def answer(step):
        if step[0] == driver.STEP_CLOCK:
            return answers["clock"]
        if step[0] == driver.STEP_POLL_HOSTS:
            return answers["poll"]
        if step[0] == driver.STEP_GATE:
            return answers["gates"][step[1]]
        return None

    out = []
    for mod in (driver, jax_driver):
        mine = dict(seen)
        steps, j = _drive(mod.tick_judgment_steps(
            epoch, fetched, rank_to_host, known, slots, mine, grace,
            timeout), answer)
        out.append((steps, j, mine))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_reshard_plan_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ids = sorted(set(_identities(rng, int(rng.integers(1, 7)))))
    table = {i: {"rank": int(rng.integers(-1, 4))} for i in ids}
    known = {i for i in ids if rng.random() < 0.6}
    recent = {i for i in ids if rng.random() < 0.3}
    pending = {"epoch": 1} if rng.random() < 0.3 else None
    enabled = bool(rng.random() < 0.8)
    assert driver.reshard_plan(table, known, enabled, pending, recent) == \
        jax_driver.reshard_plan(table, known, enabled, pending, recent)


@pytest.mark.parametrize("seed", SEEDS)
def test_reshard_commit_steps_match_jax(seed):
    rng = np.random.default_rng(seed)
    epoch = int(rng.integers(1, 5))
    survivors = sorted(set(_identities(rng)))
    acks = [None if rng.random() < 0.2 else b"x" if rng.random() < 0.1
            else str(epoch - int(rng.integers(0, 2))).encode()
            for _ in survivors]

    def answer(step):
        return acks if step[2] == "reshard_acks" else [True]

    assert _drive(driver.reshard_commit_steps(epoch, survivors), answer) == \
        _drive(jax_driver.reshard_commit_steps(epoch, survivors), answer)


# ---------------------------------------------------------------------------
# discovery, registry, payloads, signatures
# ---------------------------------------------------------------------------

class _Discovery:
    def __init__(self):
        self.hosts = {}

    def find_available_hosts_and_slots(self):
        return dict(self.hosts)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_manager_matches_jax_over_seeded_host_sets(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    clock = [100.0]
    monkeypatch.setattr(discovery.HostManager, "_now",
                        staticmethod(lambda: clock[0]))
    monkeypatch.setattr(jax_discovery.HostManager, "_now",
                        staticmethod(lambda: clock[0]))
    cooldown = [0.0, 20.0][seed % 2]
    ours_d, theirs_d = _Discovery(), _Discovery()
    ours = discovery.HostManager(ours_d, blacklist_cooldown=cooldown)
    theirs = jax_discovery.HostManager(theirs_d, blacklist_cooldown=cooldown)
    names = [f"host{i}" for i in range(5)]
    for _ in range(12):
        hosts = {h: int(rng.integers(1, 4)) for h in names
                 if rng.random() < 0.6}
        ours_d.hosts = theirs_d.hosts = hosts
        if rng.random() < 0.3:
            victim = names[int(rng.integers(0, 5))]
            assert ours.blacklist(victim) == theirs.blacklist(victim)
        clock[0] += float(rng.integers(0, 15))
        assert ours.update_available_hosts() == \
            theirs.update_available_hosts()
        assert [(h.hostname, h.slots) for h in ours.current_hosts] == \
            [(h.hostname, h.slots) for h in theirs.current_hosts]
        assert ours.total_slots() == theirs.total_slots()
        assert {h: ours.is_blacklisted(h) for h in names} == \
            {h: theirs.is_blacklisted(h) for h in names}


def test_host_discovery_script_and_fixed_hosts_match_jax(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho hostA:2\necho hostB\n\necho 10.0.0.3:4\n")
    script.chmod(0o755)
    assert discovery.HostDiscoveryScript(str(script)) \
        .find_available_hosts_and_slots() == \
        jax_discovery.HostDiscoveryScript(str(script)) \
        .find_available_hosts_and_slots() == \
        {"hostA": 2, "hostB": 1, "10.0.0.3": 4}
    spec = "a:2,b:1"
    assert discovery.FixedHosts(hosts.parse_hosts(spec)) \
        .find_available_hosts_and_slots() == \
        jax_discovery.FixedHosts(jax_hosts.parse_hosts(spec)) \
        .find_available_hosts_and_slots()


@pytest.mark.parametrize("seed", range(4))
def test_worker_state_registry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = registration.WorkerStateRegistry(3), \
        jax_registration.WorkerStateRegistry(3)
    for _ in range(10):
        op = int(rng.integers(0, 4))
        rank = int(rng.integers(0, 4))
        world = int(rng.integers(1, 4))
        for reg in (ours, theirs):
            if op == 0:
                reg.record_success(rank)
            elif op == 1:
                reg.record_failure(rank)
            elif op == 2:
                reg.record_ready(rank)
            else:
                reg.reset(world)
        for state in ("READY", "SUCCESS", "FAILURE"):
            assert ours.count(state) == theirs.count(state)
        assert ours.failed_ranks() == theirs.failed_ranks()
        assert ours.all_accounted() == theirs.all_accounted()


def test_worker_posts_match_jax_byte_for_byte():
    snap = json.dumps({"counters": {"a": 1}}).encode()
    assert rc.lease_renew_ops("h:0", 2, 5, 7, snap) == \
        jax_rc.lease_renew_ops("h:0", 2, 5, 7, snap)
    assert rc.reset_request_payload(3, "x" * 600) == \
        jax_rc.reset_request_payload(3, "x" * 600)
    assert rc.demotion_report_payload(4, 1, "h1", 0.1234567, 0.5, 3,
                                      99.5) == \
        jax_rc.demotion_report_payload(4, 1, "h1", 0.1234567, 0.5, 3, 99.5)


def test_notify_signatures_match_jax():
    key = b"k" * 32
    path = "/notify/changed?epoch=3&reshard=1"
    sig = secret.sign(key, "POST", path, b"")
    assert sig == jax_secret.sign(key, "POST", path, b"")
    assert secret.verify(key, "POST", path, b"", sig)
    assert not secret.verify(key, "POST", path + "x", b"", sig)
    assert not secret.verify(key, "POST", path, b"", None)


# ---------------------------------------------------------------------------
# the store's batch and the fault sites
# ---------------------------------------------------------------------------

@pytest.fixture
def server():
    """A job's rendezvous server in this process, fresh for each test (a
    driver's first publish is fenced on an empty store): ``store`` is the
    driver's handle on it, ``port`` what the workers' client dials."""
    srv = RendezvousServer(bind_addr="127.0.0.1")
    port = srv.start()
    yield types.SimpleNamespace(store=srv, port=port)
    srv.stop()


@pytest.fixture(scope="module")
def tcp_server():
    srv = StoreServer(local_only=True)
    yield srv
    srv.close()


@pytest.fixture
def client(server):
    """The workers' client of the rendezvous server."""
    return HTTPStoreClient("127.0.0.1", server.port, 10.0)


@pytest.mark.parametrize("seed", range(6))
def test_store_batch_matches_jax_memory_store(seed, client):
    rng = np.random.default_rng(seed)
    jax_store = JaxMemoryStore()
    scope = f"batch{seed}"
    for step in range(4):
        ops = []
        for _ in range(int(rng.integers(1, 8))):
            key = f"k{int(rng.integers(0, 4))}"
            if rng.random() < 0.5:
                ops.append(("set", scope, key,
                            f"v{step}.{int(rng.integers(0, 99))}".encode()))
            else:
                ops.append(("get", scope, key))
        ours = client.batch(ops)
        theirs = jax_store.batch(ops)
        assert [bytes(r) if isinstance(r, (bytes, bytearray)) else r
                for r in ours] == theirs, ops


def test_a_batch_of_sets_lands_in_one_server_command(client, server,
                                                     monkeypatch):
    posts = []
    post = client._keepalive_post
    monkeypatch.setattr(client, "_keepalive_post",
                        lambda path, body: posts.append(path) or
                        post(path, body))
    client.batch([("set", "table", f"h:{i}", b"x") for i in range(4)] +
                 [("set", "driver", "epoch", b"3")])
    assert posts == ["/batch"]
    assert server.store.keys("table") == [f"h:{i}" for i in range(4)]


def test_a_get_of_an_absent_key_does_not_block(client):
    t0 = time.monotonic()
    assert client.get("absent", "k") is None
    assert client.batch([("get", "absent", "k")]) == [None]
    assert time.monotonic() - t0 < 2.0


@pytest.mark.parametrize("site,call", [
    ("store.put", lambda c: c.set("s", "k", b"v")),
    ("store.put", lambda c: c.batch([("get", "s", "k")])),
    ("rendezvous.get", lambda c: c.get("s", "k"))])
def test_the_store_sites_inject_on_a_client(site, call, client, server):
    faults.configure(f"{site}:nth=2:action=raise")
    call(client)
    with pytest.raises(FaultInjectedError):
        call(client)
    call(client)
    # The driver's own handle on its server injects nothing.
    faults.configure(f"{site}:action=raise")
    server.store.batch([("set", "s", "k", b"v"), ("get", "s", "k")])
    server.store.get("s", "k")


@pytest.mark.parametrize("site,call", [
    ("store.put", lambda c: c.set("s", "k", b"v")),
    ("rendezvous.get", lambda c: c.get("s", "k"))])
def test_the_store_sites_inject_on_the_group_stores_client(site, call,
                                                          tcp_server):
    """The process groups' ``TCPStore`` client is a store client too (the
    runtime's check-in and card table); the launcher's handle is not."""
    client = Store.connect("127.0.0.1", tcp_server.port, 10.0)
    faults.configure(f"{site}:nth=2:action=raise")
    call(client)
    with pytest.raises(FaultInjectedError):
        call(client)
    call(client)
    faults.configure(f"{site}:action=raise")
    tcp_server.store.set("s", "k", b"v")
    tcp_server.store.get("s", "k")


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_the_driver_tick_site_kills_the_discovery_loop(server):
    faults.configure("driver.tick:nth=1:action=raise")
    d = driver.ElasticDriver(server.store, discovery.HostManager(
        discovery.FixedHosts(hosts.parse_hosts("localhost:1"))), min_np=1)
    d.start(lambda slot, epoch: None)
    d._discovery_thread.join(timeout=10)
    assert not d._discovery_thread.is_alive()
    assert faults._clauses[0].fired
    d.stop()


@pytest.mark.parametrize("action,seconds", [("raise", 0.0),
                                            ("delay_ms,300", 0.3)])
def test_store_get_serve_fires_in_the_servers_handler(server, action,
                                                       seconds):
    """The site is the server's GET handler: a raise drops that serve and
    the client's retry reads the value on the next; a delay holds it.  A
    PUT does not pass the site."""
    client = HTTPStoreClient("127.0.0.1", server.port, 10.0)
    faults.configure(f"store.get_serve:nth=1:action={action}")
    client.set("serve", "k", b"v")
    assert not faults._clauses[0].fired
    t0 = time.monotonic()
    assert client.get("serve", "k") == b"v"
    assert faults._clauses[0].fired
    assert time.monotonic() - t0 >= seconds


# ---------------------------------------------------------------------------
# both drivers in process, on one discovery sequence
# ---------------------------------------------------------------------------

def _table(store, ids):
    out = {}
    for i in ids:
        raw = store.get(driver.RANK_AND_SIZE_SCOPE, i)
        out[i] = json.loads(bytes(raw).decode()) if raw is not None else None
    return out


def test_both_drivers_publish_the_same_tables(server, monkeypatch):
    monkeypatch.setenv("HOROVOD_LEASE_TIMEOUT_SECS", "15")
    sequence = [{"a": 1, "b": 1}, {"a": 1}, {"a": 1, "b": 1, "c": 2},
                {"a": 1, "c": 2}, {"c": 2, "a": 1, "d": 1}]
    ids = ["a:0", "b:0", "c:0", "c:1", "d:0"]
    runs = []
    for mod, store in ((driver, server.store), (jax_driver, JaxMemoryStore())):
        disc = _Discovery()
        disc.hosts = dict(sequence[0])
        hm = (discovery if mod is driver else jax_discovery).HostManager(disc)
        d = mod.ElasticDriver(store, hm, min_np=1, max_np=4)
        spawned = []
        d._create_worker = lambda slot, epoch: spawned.append(
            (slot.hostname, slot.local_rank, slot.rank, epoch))
        d.wait_for_available_slots()
        d._rendezvous_epoch(initial=True)
        tables = [(d.epoch, _table(store, ids))]
        for hosts_now in sequence[1:]:
            disc.hosts = dict(hosts_now)
            if mod is driver:
                d._tick()
            else:
                d._tick(time.monotonic_ns())
            tables.append((d.epoch, _table(store, ids)))
        runs.append((tables, spawned))
    assert runs[0] == runs[1]
    assert [e for e, _ in runs[0][0]] == [0, 1, 2, 3, 4]


def test_a_removed_workers_clean_exit_is_not_the_jobs_success(server):
    disc = _Discovery()
    disc.hosts = {"a": 1, "b": 1}
    d = driver.ElasticDriver(server.store, discovery.HostManager(disc),
                             min_np=1)
    d._create_worker = lambda slot, epoch: None
    d.wait_for_available_slots()
    d._rendezvous_epoch(initial=True)
    b = next(s for s in d.current_slots if s.hostname == "b")
    disc.hosts = {"a": 1}
    d._tick()
    assert d.epoch == 1
    d.record_worker_exit(b, 0)       # b read rank -1 and left
    assert not d._success and d.registry.count("SUCCESS") == 0
    disc.hosts = {"a": 1, "b": 1}
    d._tick()                         # growth is still allowed
    assert d.epoch == 2 and len(d.current_slots) == 2
    crashed = next(s for s in d.current_slots if s.hostname == "b")
    d.record_worker_exit(crashed, -9)
    assert d.hosts.is_blacklisted("b")


# ---------------------------------------------------------------------------
# the launcher's flags and refusals
# ---------------------------------------------------------------------------

def test_the_elastic_flags_parse_as_in_the_jax_launcher():
    argv = ["-np", "2", "--min-np", "1", "--max-np", "3",
            "--host-discovery-script", "./d.sh", "--reset-limit", "4",
            "--host-discovery", "script", "python", "t.py"]
    ours, theirs = launch.build_parser().parse_args(argv), \
        jax_launch.build_parser().parse_args(argv)
    for key in ("num_proc", "min_np", "max_np", "host_discovery_script",
                "reset_limit", "host_discovery", "command"):
        assert getattr(ours, key) == getattr(theirs, key), key


def test_tpu_metadata_discovery_is_refused_naming_the_script(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
         "--host-discovery", "tpu-metadata", "true"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "--host-discovery-script" in proc.stderr
    assert "ROADMAP A6" in proc.stderr


def test_an_external_rendezvous_is_attached_not_hosted(tmp_path):
    """With HOROVOD_RENDEZVOUS_EXTERNAL the elastic launcher publishes to
    the named server, and its workers dial it."""
    srv = RendezvousServer(bind_addr="127.0.0.1")
    port = srv.start()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
             "1", "--min-np", "1", "sh", "-c",
             "echo rdv=$HOROVOD_GLOO_RENDEZVOUS_PORT"],
            cwd=str(tmp_path), capture_output=True, text=True, timeout=60,
            env={**os.environ, "PYTHONPATH": str(REPO),
                 "HOROVOD_RENDEZVOUS_EXTERNAL": f"127.0.0.1:{port}"})
        assert proc.returncode == 0, proc.stderr
        assert f"rdv={port}" in proc.stdout
        assert srv.get(driver.DRIVER_SCOPE, "epoch") == b"0"
        slot = json.loads(srv.get(driver.RANK_AND_SIZE_SCOPE, "localhost:0"))
        assert slot["rank"] == 0 and slot["epoch"] == 0
    finally:
        srv.stop()


def test_a_malformed_external_rendezvous_is_refused(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "1",
         "--min-np", "1", "true"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO),
             "HOROVOD_RENDEZVOUS_EXTERNAL": "nohostport"})
    assert proc.returncode != 0
    assert "must be host:port" in proc.stderr


# ---------------------------------------------------------------------------
# every rank dies: the launcher exits non-zero promptly
# ---------------------------------------------------------------------------

_ALL_DIE = textwrap.dedent("""
    import os
    import torch
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    state = hvd.elastic.ObjectState(batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < 60:
            hvd.allreduce(torch.ones(2), op=hvd.Sum, name="g")
            if state.batch == 3:
                os.kill(os.getpid(), 9)   # every rank dies
            state.batch += 1
            state.commit()

    train(state)
    print("ELASTIC_DONE", flush=True)
""")


@pytest.fixture(scope="module")
def all_die(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("all_die")
    script = tmp / "discover.sh"
    script.write_text("#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
    script.chmod(0o755)
    (tmp / "train.py").write_text(_ALL_DIE)
    t0 = time.monotonic()
    proc = run_job(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--min-np", "1", "--host-discovery-script", str(script),
         sys.executable, str(tmp / "train.py")],
        60, cwd=str(tmp), env={**os.environ, "PYTHONPATH": str(REPO)})
    return proc, time.monotonic() - t0


def test_all_ranks_dying_fails_the_job(all_die):
    proc, _ = all_die
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "ELASTIC_DONE" not in proc.stdout
    assert "all capacity lost" in proc.stderr


def test_all_ranks_dying_ends_the_job_promptly(all_die):
    _, seconds = all_die
    assert seconds < 45, seconds


# ---------------------------------------------------------------------------
# the driver's other causes, and the notify channel, in process
# ---------------------------------------------------------------------------

def _started_driver(server, hosts_now, monkeypatch, clock=None):
    disc = _Discovery()
    disc.hosts = dict(hosts_now)
    d = driver.ElasticDriver(server.store, discovery.HostManager(disc),
                             min_np=1, lease_timeout=3.0)
    d._create_worker = lambda slot, epoch: None
    if clock is not None:
        monkeypatch.setattr(driver.time, "monotonic", lambda: clock[0])
    d.wait_for_available_slots()
    d._rendezvous_epoch(initial=True)
    return d, disc


def _worker_env(monkeypatch, server, identity, epoch):
    host, local = identity.split(":")
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", "127.0.0.1")
    monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT", str(server.port))
    monkeypatch.setenv("HOROVOD_HOSTNAME", host)
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", local)
    monkeypatch.setenv("HOROVOD_EPOCH", str(epoch))


def test_a_lease_that_stops_changing_expires_and_advances(server,
                                                          monkeypatch):
    clock = [1000.0]
    d, _ = _started_driver(server, {"la": 1, "lb": 1}, monkeypatch, clock)
    for renewal in (1, 2):
        for ident in ("la:0", "lb:0"):
            server.store.batch(rc.lease_renew_ops(ident, 0, 0, renewal, b"{}"))
        d._tick()
        clock[0] += 2.0
    # lb stops renewing; la goes on.
    for renewal in (3, 4):
        server.store.batch(rc.lease_renew_ops("la:0", 0, 0, renewal, b"{}"))
        clock[0] += 2.0
        d._tick()
    assert d.epoch == 1
    table = _table(server.store, ["la:0", "lb:0"])
    assert table["la:0"]["epoch"] == 1
    # lb's host is healthy: its identity is respawned at the new epoch.
    assert table["lb:0"]["rank"] >= 0 and table["lb:0"]["epoch"] == 1


def test_a_respawned_identity_is_exempt_until_it_renews(server,
                                                         monkeypatch):
    """The lease left by a removed process must not start the clock of
    the process respawned under its identity: that one may take longer
    than the lease to reach its first renewal."""
    clock = [5000.0]
    d, disc = _started_driver(server, {"xa": 1, "xb": 1}, monkeypatch, clock)

    def tick(renewing):
        for ident, rank, epoch, n in renewing:
            server.store.batch(rc.lease_renew_ops(ident, rank, epoch, n,
                                                  b"{}"))
        d._tick()
        clock[0] += 2.0

    for n in (1, 2):
        tick([("xa:0", 0, 0, n), ("xb:0", 1, 0, n)])
    disc.hosts = {"xa": 1}
    tick([("xa:0", 0, 0, 3)])
    assert d.epoch == 1
    disc.hosts = {"xa": 1, "xb": 1}
    tick([("xa:0", 0, 1, 4)])
    assert d.epoch == 2
    for n in range(5, 10):                   # xb's new process is starting
        tick([("xa:0", 0, 2, n)])
    assert d.epoch == 2
    tick([("xa:0", 0, 2, 10), ("xb:0", 1, 2, 1)])
    for n in range(11, 15):                  # ... and then stops renewing
        tick([("xa:0", 0, 2, n)])
    assert d.epoch == 3


def test_a_reset_request_and_a_demotion_report_advance(server, monkeypatch):
    d, disc = _started_driver(server, {"ra": 1, "rb": 1}, monkeypatch)
    _worker_env(monkeypatch, server, "ra:0", 0)
    assert rc.request_reset("HorovodInternalError: a coordinated abort")
    d._tick()
    assert d.epoch == 1
    d._tick()                                  # an answered request expires
    assert d.epoch == 1
    _worker_env(monkeypatch, server, "ra:0", 1)
    victim = next(s.rank for s in d.current_slots if s.hostname == "rb")
    assert rc.post_demotion_report(victim, 0.9, 0.5, 3)
    d._tick()
    assert d.epoch == 2 and d.hosts.is_blacklisted("rb")
    assert [s.hostname for s in d.current_slots] == ["ra"]


def _grown_driver(server, monkeypatch):
    """A driver at epoch 1 after ``mb`` joined ``ma``: a reshard-marked
    table with ``mb:0`` as its joiner."""
    d, disc = _started_driver(server, {"ma": 1}, monkeypatch)
    disc.hosts = {"ma": 1, "mb": 1}
    d._tick()
    assert d.epoch == 1
    return d


def test_the_marker_read_retries_a_failed_get(server, monkeypatch):
    _grown_driver(server, monkeypatch)
    want = {"epoch": 1, "sync_root": 0, "joiners": ["mb:0"]}
    for ident in ("ma:0", "mb:0"):
        _worker_env(monkeypatch, server, ident, 1)
        faults.configure("rendezvous.get:nth=1:action=raise_oserror")
        # Both ranks read the same marker, the one whose first read failed
        # too: neither decides alone.
        assert rc.current_reshard_info(timeout=10.0) == want
        assert faults._clauses[0].fired


def test_the_marker_read_of_a_newer_epoch_raises(server, monkeypatch):
    _grown_driver(server, monkeypatch)
    _worker_env(monkeypatch, server, "ma:0", 0)
    with pytest.raises(HorovodInternalError, match="past this world's 0"):
        rc.current_reshard_info(timeout=10.0)


def test_the_marker_read_gives_up_as_an_internal_error(server, monkeypatch):
    _worker_env(monkeypatch, server, "nobody:0", 0)
    t0 = time.monotonic()
    with pytest.raises(HorovodInternalError, match="no slot entry"):
        rc.current_reshard_info(timeout=0.5)
    assert time.monotonic() - t0 < 5


def test_the_marker_read_outside_a_launched_job_is_none(monkeypatch):
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_PORT", raising=False)
    assert rc.current_reshard_info() is None


def test_the_notify_channel_is_signed_and_lands_as_a_host_update(
        server, monkeypatch):
    from horovod_tpu_torch.elastic import state as elastic_state
    from horovod_tpu_torch.elastic import worker

    _worker_env(monkeypatch, server, "nw:0", 0)
    monkeypatch.setenv("HOROVOD_SECRET_KEY", "k" * 64)
    elastic_state._consume_host_update()
    port = worker.start_notification_service()
    addr = bytes(server.store.get("workers", "nw:0")).decode()
    assert addr == f"127.0.0.1:{port}"
    # A ping signed with another key is refused.
    import urllib.error
    import urllib.request

    path = "/notify/changed?epoch=1"
    req = urllib.request.Request(f"http://{addr}{path}", data=b"",
                                 method="POST")
    req.add_header(secret.SIG_HEADER,
                   secret.sign(b"x" * 64, "POST", path, b""))
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with pytest.raises(urllib.error.HTTPError) as err:
        opener.open(req, timeout=5)
    assert err.value.code == 403
    assert elastic_state._consume_host_update() is None
    worker.WorkerNotificationClient([addr]).notify_hosts_updated(
        added_only=True, epoch=1)
    assert elastic_state._consume_host_update() is False
    worker.WorkerNotificationClient([addr]).notify_hosts_updated(
        added_only=False, epoch=1, reshard=True)   # size 1: nothing to abort
    assert elastic_state._consume_host_update() is True
