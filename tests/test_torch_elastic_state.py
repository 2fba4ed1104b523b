"""The worker side of the port's elastic training against the JAX package.

In process (exact, for everything here):

- ``ObjectState`` commit/restore/sync on seeded sequences, beside the JAX
  ``ObjectState`` (its sync through a stand-in broadcast);
- ``ElasticSampler``'s index sequences for the same seed, rank, size and
  processed set, beside the JAX bridge's (``horovod_tpu.frameworks.torch.
  elastic``);
- ``TorchState``'s handler snapshots (model, optimizer, sampler) beside the
  bridge's, and the optimizer layout a joiner adopts before the sync;
- the host-update consume rule: reference Horovod's, where the JAX
  package's inverts it (the growth difference: the JAX survivors skip the
  sync while the joiner waits in it), and the sync skipped only where the
  reshard marker says so, whatever the interrupt's flag;
- the ``run`` wrapper's retries at size 1, the runtime's teardown, the
  reshard abort's epoch filter and the abortable host-plane wait.

And one module-scoped job through the elastic launcher: rank 1 SIGKILLs
itself mid-step; its host is blacklisted, the survivor resumes at size 1
from its last commit, bit for bit, and a whole-step graph built before the
reset refuses to run after it.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import horovod_tpu.frameworks.torch as jax_torch
from horovod_tpu.elastic import state as jax_state
from horovod_tpu.frameworks.jax import functions as jax_functions
from horovod_tpu.frameworks.torch import elastic as jax_torch_elastic
import horovod_tpu_torch as hvd
from horovod_tpu_torch import functions
from horovod_tpu_torch.common import env as env_mod
from horovod_tpu_torch.common.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.core import state as core_state
from horovod_tpu_torch.elastic import state as elastic_state
from horovod_tpu_torch.elastic import torch_state
from horovod_tpu_torch.transport import control

from .torch_port import one_torch_thread  # noqa: F401  (autouse)
from .torch_port import run_job

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_updates():
    for mod in (elastic_state, jax_state):
        mod._consume_host_update()
    yield
    for mod in (elastic_state, jax_state):
        mod._consume_host_update()


# ---------------------------------------------------------------------------
# ObjectState
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_object_state_commit_restore_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ours = elastic_state.ObjectState(batch=0, acc=[0], tag="a")
    theirs = jax_state.ObjectState(batch=0, acc=[0], tag="a")
    for _ in range(20):
        op = int(rng.integers(0, 4))
        value = int(rng.integers(0, 100))
        for st in (ours, theirs):
            if op == 0:
                st.batch = value
                st.acc.append(value)
            elif op == 1:
                st.save()
            elif op == 2:
                st.restore()
            else:
                st.tag = str(value)
        assert (ours.batch, ours.acc, ours.tag) == \
            (theirs.batch, theirs.acc, theirs.tag)
        assert ours._saved == theirs._saved


def test_object_state_sync_adopts_the_roots_attributes_like_jax(monkeypatch):
    root = {"a": 10, "c": [3, 4]}

    def fake(values, root_rank=0, name=""):
        assert set(values) == {"a", "b"}
        return copy.deepcopy(root)

    monkeypatch.setattr(functions, "broadcast_object", fake)
    monkeypatch.setattr(jax_functions, "broadcast_object", fake)
    ours, theirs = elastic_state.ObjectState(a=1, b=2), \
        jax_state.ObjectState(a=1, b=2)
    ours.sync(root_rank=0)
    theirs.sync(root_rank=0)
    assert ours._known == theirs._known == ["a", "c"]
    assert ours._saved == theirs._saved
    ours.a = 99
    ours.restore()
    assert ours.a == 10


# ---------------------------------------------------------------------------
# the host-update consume rule, and the growth difference
# ---------------------------------------------------------------------------

# (pings as (added_only, epoch), the port's answer, the JAX package's).
_PINGS = [
    # Only additions: the JAX survivor skips the sync that the process
    # which joined waits in; the port's syncs.
    ([(True, 1)], False, True),
    ([(True, None)], False, True),
    ([(True, 1), (True, 2)], False, True),
    # Only removals: reference Horovod skips the sync (every process left
    # holds the committed state); the JAX package syncs.
    ([(False, 1)], True, False),
    ([(False, 1), (False, 2)], True, False),
    # Both: both sync.
    ([(False, 1), (True, 2)], False, False),
    ([(True, 1), (False, 1)], False, False),
    # A ping not newer than this worker's epoch is stale in both.
    ([(False, 0)], None, None),
    ([(True, 0)], None, None),
]


@pytest.mark.parametrize("pings,ours_want,theirs_want", _PINGS)
def test_consume_follows_reference_horovod_where_jax_inverts_it(
        pings, ours_want, theirs_want, monkeypatch):
    monkeypatch.setenv(env_mod.HOROVOD_EPOCH, "0")
    for added_only, epoch in pings:
        elastic_state.notify_hosts_updated(added_only=added_only, epoch=epoch)
        jax_state.notify_hosts_updated(added_only=added_only, epoch=epoch)
    assert elastic_state._consume_host_update() is ours_want
    assert jax_state._consume_host_update() is theirs_want
    assert elastic_state._consume_host_update() is None


class _Synced(elastic_state.ObjectState):
    def __init__(self):
        super().__init__(batch=0)
        self.roots = []

    def sync(self, root_rank=0):
        self.roots.append(root_rank)


@pytest.mark.parametrize("marker,reshard,want", [
    # The marker decides, the same on every rank.
    ({"epoch": 2, "sync_root": 1, "joiners": ["h:0"]}, "1", [1]),
    ({"epoch": 2, "sync_root": 0, "joiners": []}, "1", []),
    # Without it (or with resharding off) every rank syncs from rank 0.
    (None, "1", [0]),
    ({"epoch": 2, "sync_root": 0, "joiners": []}, "0", [0]),
])
def test_the_sync_is_skipped_only_where_every_rank_agrees(
        marker, reshard, want, monkeypatch):
    from horovod_tpu_torch.elastic import rendezvous_client

    monkeypatch.setenv(env_mod.HOROVOD_ELASTIC, "1")
    monkeypatch.setenv(env_mod.HOROVOD_EPOCH, "2")
    monkeypatch.setenv(env_mod.HOROVOD_RESHARD, reshard)
    monkeypatch.setattr(rendezvous_client, "current_reshard_info",
                        lambda: marker)
    st = _Synced()
    elastic_state._sync_for_epoch(st)
    assert st.roots == want


@pytest.mark.parametrize("skip_sync", [True, False])
def test_run_syncs_after_an_interrupt_whatever_its_skip_flag(
        skip_sync, monkeypatch):
    """No rank skips the sync on its own flag: without a marker the retry
    after a ``HostsUpdatedInterrupt`` syncs from rank 0."""
    monkeypatch.delenv(env_mod.HOROVOD_ELASTIC, raising=False)
    monkeypatch.setattr(elastic_state, "_reset_and_reinit",
                        lambda: hvd.init(device="cpu"))
    hvd.init(device="cpu")
    try:
        st = _Synced()

        @hvd.elastic.run
        def train(state):
            if len(state.roots) == 1:
                raise HostsUpdatedInterrupt(skip_sync=skip_sync)
            return len(state.roots)

        assert train(st) == 2
        assert st.roots == [0, 0]
    finally:
        hvd.shutdown()


def test_check_host_updates_raises_with_the_skip_flag(monkeypatch):
    monkeypatch.setenv(env_mod.HOROVOD_EPOCH, "3")
    st = elastic_state.ObjectState(batch=1)
    st.check_host_updates()
    elastic_state.notify_hosts_updated(added_only=True, epoch=4)
    with pytest.raises(HostsUpdatedInterrupt) as err:
        st.commit()
    assert err.value.skip_sync is False
    elastic_state.notify_hosts_updated(added_only=False, epoch=4)
    with pytest.raises(HostsUpdatedInterrupt) as err:
        st.check_host_updates()
    assert err.value.skip_sync is True


# ---------------------------------------------------------------------------
# ElasticSampler and TorchState against the JAX bridge
# ---------------------------------------------------------------------------

def _world(monkeypatch, rank, size):
    monkeypatch.setattr(torch_state, "rank", lambda: rank)
    monkeypatch.setattr(torch_state, "size", lambda: size)
    monkeypatch.setattr(jax_torch, "rank", lambda: rank)
    monkeypatch.setattr(jax_torch, "size", lambda: size)


@pytest.mark.parametrize("seed", range(10))
def test_elastic_sampler_sequences_match_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    size = int(rng.integers(1, 5))
    rank = int(rng.integers(0, size))
    shuffle = bool(rng.random() < 0.7)
    _world(monkeypatch, rank, size)
    data = list(range(n))
    ours = torch_state.ElasticSampler(data, shuffle=shuffle, seed=seed)
    theirs = jax_torch_elastic.ElasticSampler(data, shuffle=shuffle,
                                              seed=seed)
    for epoch in range(2):
        assert list(iter(ours)) == list(iter(theirs))
        assert len(ours) == len(theirs)
        bs = int(rng.integers(1, 4))
        for b in range(int(rng.integers(0, 3))):
            ours.record_batch(b, bs)
            theirs.record_batch(b, bs)
        # A reshard to another world, mid-epoch.
        size = int(rng.integers(1, 5))
        rank = int(rng.integers(0, size))
        _world(monkeypatch, rank, size)
        ours.reset()
        theirs.reset()
        assert list(iter(ours)) == list(iter(theirs))
        assert ours.state_dict() == theirs.state_dict()
        ours.set_epoch(epoch + 1)
        theirs.set_epoch(epoch + 1)


def _model_and_opt(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.BatchNorm1d(6),
                                torch.nn.Linear(6, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return model, opt


def _step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    opt.zero_grad()
    model(torch.randn(8, 4, generator=g)).square().mean().backward()
    opt.step()


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("seed", range(4))
def test_torch_state_snapshots_match_the_bridges(seed, monkeypatch):
    _world(monkeypatch, 0, 1)
    runs = []
    for mod in (torch_state, jax_torch_elastic):
        model, opt = _model_and_opt(seed)
        sampler = mod.ElasticSampler(list(range(20)), seed=seed)
        st = mod.TorchState(model, opt, sampler=sampler, batch=0, note="x")
        trace = []
        for k in range(6):
            _step(model, opt, 100 * seed + k)
            st.batch += 1
            list(iter(sampler))
            sampler.record_batch(k % 3, 2)
            if k % 2:
                st.save()
            else:
                st.restore()
            trace.append((copy.deepcopy(model.state_dict()),
                          copy.deepcopy(opt.state_dict()),
                          sampler.state_dict(), st.batch, st.note))
        runs.append(trace)
    for ours, theirs in zip(*runs):
        assert _same(ours, theirs)


def test_torch_state_takes_a_distributed_optimizer(monkeypatch):
    _world(monkeypatch, 0, 1)
    hvd.init(device="cpu")
    try:
        model, inner = _model_and_opt(0)
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())
        st = hvd.elastic.TorchState(model, opt, batch=0)
        assert isinstance(st._handlers["optimizer"],
                          torch_state.OptimizerStateHandler)
        _step(model, opt, 1)
        st.commit()
        saved = copy.deepcopy(inner.state_dict())
        # A backward whose allreduces die with the world: the restore
        # drops them, and the next step runs.
        model(torch.randn(8, 4)).square().mean().backward()
        assert opt._handles
        st.restore()
        assert not opt._handles
        assert _same(inner.state_dict(), saved)
        # This world lives on and finishes the dropped allreduces in the
        # background: their names are free again once it has taken them.
        deadline = time.monotonic() + 10
        while core_state.global_state().tensor_queue.names() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        _step(model, opt, 2)
    finally:
        hvd.shutdown()


def test_a_joiners_optimizer_adopts_the_roots_layout(monkeypatch):
    model, opt = _model_and_opt(0)
    _step(model, opt, 0)
    root_layout = {}

    def fake_root(obj, root_rank=0, name=""):
        root_layout["layout"] = obj
        return obj

    _world(monkeypatch, 0, 2)
    monkeypatch.setattr(torch_state, "broadcast_object", fake_root)
    torch_state._align_optimizer_state(opt, 0)
    joiner_model, joiner_opt = _model_and_opt(1)
    assert not joiner_opt.state_dict()["state"]
    _world(monkeypatch, 1, 2)
    monkeypatch.setattr(torch_state, "broadcast_object",
                        lambda obj, root_rank=0, name="":
                        root_layout["layout"])
    torch_state._align_optimizer_state(joiner_opt, 0)
    ours, theirs = joiner_opt.state_dict()["state"], \
        opt.state_dict()["state"]
    assert ours.keys() == theirs.keys()
    for pid in ours:
        for key, value in theirs[pid].items():
            assert ours[pid][key].shape == value.shape
            assert ours[pid][key].dtype == value.dtype
            assert not ours[pid][key].any()


# ---------------------------------------------------------------------------
# the run wrapper, the teardown and the aborts, at size 1 in process
# ---------------------------------------------------------------------------

def test_run_restores_and_retries_after_a_collective_failure(monkeypatch):
    monkeypatch.delenv(env_mod.HOROVOD_ELASTIC, raising=False)
    monkeypatch.setattr(elastic_state, "_reset_and_reinit",
                        lambda: hvd.init(device="cpu"))
    hvd.init(device="cpu")
    try:
        st = elastic_state.ObjectState(batch=0)
        calls, resets = [], []
        st.register_reset_callbacks([lambda: resets.append(hvd.size())])

        @hvd.elastic.run
        def train(state):
            calls.append(state.batch)
            while state.batch < 4:
                state.batch += 1
                if state.batch == 3 and len(calls) == 1:
                    raise HorovodInternalError("a peer died")
                state.commit()
            return state.batch

        assert train(st) == 4
        assert calls == [0, 2]      # resumed at the last commit
        assert resets == [1]
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("knob,value", [
    (env_mod.HOROVOD_ELASTIC, "1"), (env_mod.HOROVOD_METRICS_PUSH_SECS, "2")])
def test_the_elastic_knobs_are_accepted_at_init(knob, value, monkeypatch):
    monkeypatch.setenv(knob, value)
    hvd.init(device="cpu")
    assert hvd.is_initialized()
    hvd.shutdown()


def test_the_teardown_reads_as_not_initialized_and_never_waits(monkeypatch):
    hvd.init(device="cpu")
    assert hvd.is_initialized()
    old = core_state.global_state()
    t0 = time.monotonic()
    hvd.basics._internal_reset()
    assert time.monotonic() - t0 < 5
    assert old.shutdown_complete.is_set()
    assert not hvd.is_initialized()
    assert hvd.basics.init_device() is not None
    hvd.init(device="cpu")
    assert hvd.is_initialized()
    hvd.shutdown()


def test_the_reshard_abort_is_epoch_filtered(monkeypatch):
    monkeypatch.setenv(env_mod.HOROVOD_EPOCH, "5")
    st = core_state.global_state()
    monkeypatch.setattr(st.initialized, "is_set", lambda: True)
    monkeypatch.setattr(st, "topo", type("T", (), {"size": 2})())
    try:
        core_state.abort_for_reshard(5)
        core_state.abort_for_reshard(4)
        assert control.abort_reason() is None
        core_state.abort_for_reshard(6)
        assert "epoch 6" in control.abort_reason()
    finally:
        control.clear_abort()


def test_an_abort_unblocks_a_host_plane_wait():
    import torch.distributed as dist

    store = dist.HashStore()
    peers = {}

    def second_rank():
        peers[1] = dist.ProcessGroupGloo(store, 1, 2,
                                         datetime.timedelta(seconds=30))
    t = threading.Thread(target=second_rank, daemon=True)
    t.start()
    group = dist.ProcessGroupGloo(store, 0, 2, datetime.timedelta(seconds=30))
    t.join()
    # Rank 1 is connected and alive but never joins: the allreduce would
    # wait out the group's 30 s timeout.
    work = group.allreduce([torch.ones(3)])
    threading.Timer(0.5, control.abort, ("peer gone",)).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(HorovodInternalError, match="peer gone"):
            control.wait(work)
    finally:
        control.clear_abort()
    assert time.monotonic() - t0 < 5
    # Once rank 1 joins, the abandoned allreduce completes.
    peers[1].allreduce([torch.ones(3)]).wait()


# ---------------------------------------------------------------------------
# one job: a rank SIGKILLs itself mid-step
# ---------------------------------------------------------------------------

_KILL = textwrap.dedent("""
    import hashlib, os
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    hvd.init(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model, opt, batch=0)
    # A whole-step graph of the first world (uncaptured on the CPU; its
    # average runs on a group of its own).
    step = hvd.make_overlapped_train_step(
        model, lambda m, b: torch.nn.functional.cross_entropy(m(b[0]), b[1]),
        torch.optim.SGD(model.parameters(), lr=0.0))
    step((torch.zeros(2, 4), torch.zeros(2, dtype=torch.long)))

    def digest(batch):
        h = hashlib.sha256()
        for t in list(model.parameters()) + [
                v for s in inner.state.values() for v in s.values()]:
            h.update(t.detach().numpy().tobytes())
        h.update(str(batch).encode())
        return h.hexdigest()

    @hvd.elastic.run
    def train(state):
        print(f"ENTER batch={state.batch} size={hvd.size()} "
              f"hash={digest(state.batch)}", flush=True)
        if hvd.size() == 1:
            try:
                step((torch.zeros(2, 4), torch.zeros(2, dtype=torch.long)))
            except HorovodInternalError as e:
                print("GRAPH_STEP_REFUSED", "torn down" in str(e), flush=True)
        while state.batch < 6:
            g = torch.Generator().manual_seed(100 * state.batch + hvd.rank())
            x = torch.randn(16, 4, generator=g)
            y = torch.randint(0, 2, (16,), generator=g)
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(model(x), y)
            if state.batch == 3 and hvd.size() == 2 and hvd.rank() == 1:
                os.kill(os.getpid(), 9)
            loss.backward()
            opt.step()
            print(f"BATCH {state.batch} rank={hvd.rank()} size={hvd.size()}",
                  flush=True)
            state.batch += 1
            state.commit()
            print(f"COMMIT batch={state.batch} hash={digest(state.batch)} "
                  f"rank={hvd.rank()}", flush=True)

    train(state)
    print("ELASTIC_DONE", hvd.rank(), hvd.size(), flush=True)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("killed")
    script = tmp / "discover.sh"
    script.write_text("#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
    script.chmod(0o755)
    (tmp / "train.py").write_text(_KILL)
    proc = run_job(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np", "2",
         "--min-np", "1", "--host-discovery-script", str(script),
         sys.executable, str(tmp / "train.py")],
        60, cwd=str(tmp), env={**os.environ, "PYTHONPATH": str(REPO)})
    return proc


def test_the_job_survives_a_killed_rank(killed):
    assert killed.returncode == 0, killed.stdout + killed.stderr
    assert "ELASTIC_DONE 0 1" in killed.stdout
    assert "blacklisting host 127.0.0.1" in killed.stderr


def test_the_survivor_resumes_from_its_last_commit_bit_for_bit(killed):
    out = killed.stdout
    sizes = [(int(b), int(s)) for b, r, s in
             re.findall(r"BATCH (\d+) rank=(\d+) size=(\d+)", out) if r == "0"]
    assert sizes == [(0, 2), (1, 2), (2, 2), (3, 1), (4, 1), (5, 1)], out
    commits = re.findall(r"COMMIT batch=(\d+) hash=(\w+) rank=0", out)
    enters = re.findall(r"ENTER batch=(\d+) size=(\d+) hash=(\w+)", out)
    resumed = [(b, h) for b, s, h in enters if s == "1"]
    assert resumed == [(commits[2][0], commits[2][1])], (commits, enters)
    assert resumed[0][0] == "3"


def test_a_graph_step_of_the_old_world_refuses_after_the_reset(killed):
    assert "GRAPH_STEP_REFUSED True" in killed.stdout, killed.stdout


def test_a_host_plane_send_and_recv_outlast_the_aborts_poll():
    """The narrow ring's hop (``Allreduce._exchange``) with a peer that
    posts its side late: a timed wait would end the send and close the
    pair, so point-to-point works are waited on whole."""
    import torch.distributed as dist

    from horovod_tpu_torch.backend.cuda import Allreduce
    from horovod_tpu_torch.common.env import PLANE_HOST
    from horovod_tpu_torch.common.topology import ProcessTopology

    store = dist.HashStore()
    groups, got = {}, {}

    def rank(r):
        groups[r] = dist.ProcessGroupGloo(store, r, 2,
                                          datetime.timedelta(seconds=30))
        if r == 1:
            time.sleep(0.6)   # six of the abort's polls
        op = Allreduce(ProcessTopology(rank=r, size=2, local_rank=r,
                                       local_size=2), torch.device("cpu"),
                       PLANE_HOST, groups[r])
        send = torch.full((1 << 16,), float(r + 1), dtype=torch.bfloat16)
        recv = torch.empty_like(send)
        op._exchange(send, recv)
        got[r] = recv

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert torch.equal(got[0], torch.full_like(got[0], 2.0))
    assert torch.equal(got[1], torch.full_like(got[1], 1.0))
