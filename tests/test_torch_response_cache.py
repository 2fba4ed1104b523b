"""The port's response cache and mask fast path against the JAX package.

In one process, on inputs made from numpy seeds:

- ``CoordinatorCache`` and ``WorkerCacheMirror`` driven by the same random
  sequences of inserts, lookups, rehydrations, ticks and invalidations in
  both packages give the same bits, evictions, tombstone answers and
  recycled bits;
- the mask, abort, request-list and response-list frames with cache fields
  are the same bytes in both packages, and each package decodes the
  other's;
- a lockstep harness steps every rank of both packages' controllers one
  cycle at a time (``_worker_payload``, the coordinator round over a fake
  transport, ``_apply_reply``) through training-like streams: the same
  names every step, arriving in different cycles on different ranks, one
  shape change, an allgather (never cached), a broadcast, a tensor
  re-submitted before it completes, and a JOIN at the end.  Every cycle,
  each worker's frame, rank 0's verdict, every rank's ``ResponseList`` and
  the six cache counters must be equal;
- the launcher's runtime flags become the same ``HOROVOD_*`` variables as
  the JAX launcher's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from horovod_tpu.common.topology import ProcessTopology as JaxTopology
from horovod_tpu.core import controller as jax_controller
from horovod_tpu.core import messages as jax_messages
from horovod_tpu.core import response_cache as jax_cache
from horovod_tpu.runner import config_parser as jax_config
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu_torch.common.topology import ProcessTopology
from horovod_tpu_torch.core import controller, messages, response_cache
from horovod_tpu_torch.runner import launch

from .torch_port import one_torch_thread  # noqa: F401  (autouse)

JOIN = controller.JOIN_TENSOR_NAME
COUNTERS = ("cache_hit_count", "cache_miss_count", "fast_cycle_count",
            "idle_fast_cycle_count", "mask_only_sent_count",
            "serialized_request_count")


def _request(mod, fields: dict):
    return mod.Request(**{
        **fields, "request_type": mod.RequestType[fields["request_type"]],
        "tensor_type": mod.DataType[fields["tensor_type"]]})


def _plain(obj):
    """A message as plain data, enums by name, for comparing across the
    packages."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.name != "tuned_params"}
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if hasattr(obj, "name") and hasattr(obj, "value"):
        return obj.name
    return obj


# ---------------------------------------------------------------------------
# (a) the cache and the mirror
# ---------------------------------------------------------------------------

_OPS = ["ALLREDUCE", "ALLREDUCE", "BROADCAST", "ADASUM", "ALLGATHER"]


def _random_request(rng):
    return dict(request_rank=int(rng.randint(4)),
                request_type=_OPS[rng.randint(len(_OPS))],
                tensor_name=f"t{rng.randint(6)}",
                tensor_type=["FLOAT32", "BFLOAT16"][rng.randint(2)],
                tensor_shape=[int(rng.choice([4, 8]))],
                root_rank=int(rng.choice([-1, 0])),
                device=int(rng.choice([-1, 0])))


@pytest.mark.parametrize("capacity", [1, 2, 1024])
@pytest.mark.parametrize("seed", range(3))
def test_cache_and_mirror_sequences_match_jax(seed, capacity):
    rng = np.random.RandomState(seed)
    ours, theirs = (response_cache.CoordinatorCache(capacity),
                    jax_cache.CoordinatorCache(capacity))
    mirrors = (response_cache.WorkerCacheMirror(),
               jax_cache.WorkerCacheMirror())
    seen = []
    kinds = {"insert": 0, "evicted": 0, "tombstone": 0, "recycled": 0}
    assigned = set()
    for _ in range(300):
        op = rng.choice(["insert", "lookup", "rehydrate", "tick",
                         "invalidate", "hit"], p=[.4, .15, .15, .15, .05, .1])
        fields = _random_request(rng)
        bit = int(rng.randint(8))
        if op == "insert":
            a = ours.maybe_insert(_request(messages, fields))
            b = theirs.maybe_insert(_request(jax_messages, fields))
            assert a == b, fields
            new_bit, evicted = a
            kinds["insert"] += new_bit is not None
            kinds["evicted"] += len(evicted)
            if new_bit is not None:
                kinds["recycled"] += new_bit in assigned
                assigned.add(new_bit)
            for mirror, mod in zip(mirrors, (messages, jax_messages)):
                mirror.apply([] if new_bit is None else
                             [(new_bit, _request(mod, fields))], evicted)
            seen.append(a)
        elif op == "lookup":
            assert ours.lookup(response_cache.cache_key(
                _request(messages, fields))) == theirs.lookup(
                jax_cache.cache_key(_request(jax_messages, fields)))
        elif op == "rehydrate":
            rank = int(rng.randint(4))
            a, b = ours.rehydrate(bit, rank), theirs.rehydrate(bit, rank)
            assert _plain(a) == _plain(b), bit
            live = bit in ours._by_bit
            kinds["tombstone"] += a is not None and not live
        elif op == "tick":
            ours.tick()
            theirs.tick()
        elif op == "invalidate":
            assert ours.invalidate_name(fields["tensor_name"]) == \
                theirs.invalidate_name(fields["tensor_name"])
        else:
            a = mirrors[0].hit(_request(messages, fields))
            assert a == mirrors[1].hit(_request(jax_messages, fields))
            assert _plain(mirrors[0].template(bit)) == \
                _plain(mirrors[1].template(bit))
        assert len(ours) == len(theirs) <= capacity
        assert sorted(ours._free_bits) == sorted(theirs._free_bits)
        assert len(mirrors[0]) == len(mirrors[1])
    assert kinds["insert"] > 0 and seen
    if capacity < 1024:
        assert kinds["evicted"] > 0 and kinds["recycled"] > 0, kinds


def test_cache_key_separates_host_and_card_tensors():
    """AdamW's 0-d ``step`` on the host and a moment on the card may carry
    the same name; they never share a bit."""
    cache = response_cache.CoordinatorCache(8)
    host = dict(request_rank=0, request_type="BROADCAST", tensor_name="s",
                tensor_type="FLOAT32", tensor_shape=[], root_rank=0,
                device=-1)
    bit_host, _ = cache.maybe_insert(_request(messages, host))
    card = _request(messages, dict(host, device=0))
    assert cache.lookup(response_cache.cache_key(card)) is None
    bit_card, evicted = cache.maybe_insert(card)
    assert evicted == [bit_host] and bit_card != bit_host
    assert response_cache.cache_key(card) == jax_cache.cache_key(
        _request(jax_messages, dict(host, device=0)))


# ---------------------------------------------------------------------------
# (b) the frames
# ---------------------------------------------------------------------------

def _request_fields(rng, rank):
    return dict(_random_request(rng), request_rank=rank,
                splits=[int(d) for d in rng.randint(0, 9, rng.randint(3))])


def _frames(mod, seed):
    rng = np.random.RandomState(seed)
    mask = bytes(rng.randint(0, 256, rng.randint(0, 40)).astype(np.uint8))
    reason = "".join(rng.choice(list("abcé€ 日"), rng.randint(0, 700)))
    reqs = [_request(mod, _request_fields(rng, r)) for r in range(3)]
    tpl = [_request(mod, _request_fields(rng, 0)) for _ in range(2)]
    resp = mod.Response(response_type=mod.ResponseType.ALLREDUCE,
                        tensor_names=["a", "b"], tensor_sizes=[3, 5],
                        devices=[0])
    shutdown = bool(rng.rand() < 0.5)
    return [
        mod.MaskFrame(mask=mask, shutdown=shutdown),
        mod.AbortFrame(epoch=int(rng.randint(3)), origin_rank=0,
                       reason=reason),
        mod.RequestList(requests=reqs, shutdown=shutdown,
                        cache_hits=[int(b) for b in rng.randint(0, 99, 3)],
                        cache_mask=mask),
        mod.ResponseList(responses=[resp], shutdown=shutdown,
                         cache_assignments=[(int(rng.randint(99)), t)
                                            for t in tpl],
                         evicted_bits=[int(b) for b in rng.randint(0, 99, 2)]),
    ]


@pytest.mark.parametrize("kind", range(4),
                         ids=["mask", "abort", "request_list",
                              "response_list"])
@pytest.mark.parametrize("seed", range(3))
def test_cache_and_abort_frames_match_jax_bytes(seed, kind):
    ours = _frames(messages, seed)[kind]
    theirs = _frames(jax_messages, seed)[kind]
    data = ours.to_bytes()
    assert data == theirs.to_bytes()
    assert _plain(type(ours).from_bytes(theirs.to_bytes())) == _plain(ours)
    assert _plain(type(theirs).from_bytes(data)) == _plain(theirs)
    assert messages.is_mask_frame(data) == (kind == 0) == \
        jax_messages.is_mask_frame(data)
    assert messages.is_abort_frame(data) == (kind == 1) == \
        jax_messages.is_abort_frame(data)


def test_an_over_long_abort_reason_is_capped_as_in_jax():
    reason = "stall shutdown: " + "€" * 400
    ours = messages.AbortFrame(reason=reason)
    theirs = jax_messages.AbortFrame(reason=reason)
    assert ours.reason == theirs.reason
    assert ours.reason.endswith("…[truncated]")
    assert len(ours.reason.encode()) <= messages.MAX_ABORT_REASON_BYTES
    assert ours.to_bytes() == theirs.to_bytes()


# ---------------------------------------------------------------------------
# (c) the lockstep harness
# ---------------------------------------------------------------------------

class _Coordinator:
    """Rank 0's transport in both packages: the workers' frames of the
    cycle in, the verdict out (the port's gather/broadcast; the JAX star's
    recv/send)."""

    def __init__(self):
        self.frames, self.verdict = [], None

    def gather(self, payload):
        assert payload == b""
        return [b""] + self.frames

    def broadcast(self, payload):
        self.verdict = payload
        return payload

    def recv(self, worker):
        return self.frames[worker - 1]

    def send(self, worker, payload):
        if worker == 1:
            self.verdict = payload


def _stream(seed: int, size: int):
    """Per cycle, per rank, the request fields.  Eight steps of the same
    names, then an idle cycle each.  In steps 0-4 each rank's requests are
    spread over three cycles in its own order, with an allgather; step 3
    changes ``g1``'s shape; in step 2 rank 1 submits ``g0`` twice before
    the others.  Steps 5 and 6 are synchronized (every rank submits
    everything in one cycle: the steady state).  In step 7 the last rank
    joins instead, and every rank joins in the end."""
    rng = np.random.RandomState(seed)
    names = [f"g{i}" for i in range(5)]
    shapes = {n: [int(rng.randint(1, 40))] for n in names}
    join = [dict(request_rank=r, request_type="JOIN", tensor_name=JOIN,
                 tensor_type="FLOAT32") for r in range(size)]
    cycles = []
    for step in range(8):
        if step == 3:
            shapes["g1"] = shapes["g1"] + [2]
        per_rank = []
        for rank in range(size):
            reqs = [dict(request_rank=rank, request_type="ALLREDUCE",
                         tensor_name=n, tensor_type="FLOAT32",
                         tensor_shape=shapes[n], device=0,
                         postscale_factor=1.0 / size) for n in names]
            reqs.append(dict(request_rank=rank, request_type="BROADCAST",
                             tensor_name="bcast", tensor_type="INT32",
                             tensor_shape=[3], root_rank=0, device=-1))
            if step < 5:
                reqs.append(dict(request_rank=rank, request_type="ALLGATHER",
                                 tensor_name="ag", tensor_type="FLOAT32",
                                 tensor_shape=[rank + step + 1, 2],
                                 device=0))
            order = [reqs[i] for i in rng.permutation(len(reqs))]
            cuts = sorted(rng.randint(0, len(order) + 1, 2))
            chunks = [order[:cuts[0]], order[cuts[0]:cuts[1]],
                      order[cuts[1]:]]
            if step == 2 and rank == 1:
                g0 = next(r for r in order if r["tensor_name"] == "g0")
                chunks = [[g0], [g0] + [r for r in order if r is not g0], []]
            if step in (5, 6):
                chunks = [order, [], []]
            if step == 7 and rank == size - 1:
                chunks = [[join[rank]], [], []]
            per_rank.append(chunks)
        for c in range(3):
            cycles.append([per_rank[r][c] for r in range(size)])
        cycles.append([[] for _ in range(size)])
    cycles.append([[join[r]] if r < size - 1 else [] for r in range(size)])
    cycles.append([[] for _ in range(size)])
    return cycles


def _controllers(pkg, size, capacity):
    mod_ctl, topo_cls = (controller, ProcessTopology) if pkg == "port" \
        else (jax_controller, JaxTopology)
    wire = _Coordinator()
    ranks = []
    for rank in range(size):
        topo = topo_cls(rank=rank, size=size, local_rank=rank,
                        local_size=size)
        link = wire if rank == 0 else object()
        ranks.append(mod_ctl.Controller(topo, link,
                                        fusion_threshold_bytes=256,
                                        cache_capacity=capacity))
    return wire, ranks


def _cycle(mod, wire, ranks, requests):
    """One cycle of every rank: the workers' frames, rank 0's round, the
    workers' decoding.  Returns (frames, verdict, ResponseLists)."""
    frames = [ctl._worker_payload([_request(mod, f) for f in reqs], False)
              for ctl, reqs in zip(ranks[1:], requests[1:])]
    wire.frames = frames
    lists = [ranks[0].compute_response_list(
        [_request(mod, f) for f in requests[0]])]
    lists += [ctl._apply_reply(wire.verdict) for ctl in ranks[1:]]
    return frames, wire.verdict, lists


@pytest.mark.parametrize("capacity", [0, 2, 1024])
@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("seed", range(2))
def test_lockstep_rounds_match_jax_controller(seed, size, capacity):
    ours_wire, ours = _controllers("port", size, capacity)
    jax_wire, theirs = _controllers("jax", size, capacity)
    done, evicted = [], 0
    for c, requests in enumerate(_stream(seed, size)):
        a = _cycle(messages, ours_wire, ours, requests)
        b = _cycle(jax_messages, jax_wire, theirs, requests)
        assert a[0] == b[0], f"cycle {c}: worker frames"
        assert a[1] == b[1], f"cycle {c}: verdict"
        assert _plain(a[2]) == _plain(b[2]), f"cycle {c}: response lists"
        # Every rank executes rank 0's responses.
        assert all(_plain(rl.responses) == _plain(a[2][0].responses)
                   for rl in a[2])
        for ctl, jctl in zip(ours, theirs):
            assert [getattr(ctl, k) for k in COUNTERS] == \
                [getattr(jctl, k) for k in COUNTERS], f"cycle {c}"
        done += [n for r in a[2][0].responses for n in r.tensor_names]
        evicted += len(a[2][0].evicted_bits)
    assert done[-1] == JOIN
    workers = ours[1:]
    if capacity == 2:
        assert evicted > 0 and all(w.cache_hit_count > 0 for w in workers)
    elif capacity:
        assert all(w.cache_hit_count > w.cache_miss_count for w in workers)
        assert all(w.mask_only_sent_count > 0 for w in workers)
        assert sum(w.fast_cycle_count for w in workers) > 0
        assert sum(w.idle_fast_cycle_count for w in workers) > 0
    else:
        assert not any(getattr(ctl, k) for ctl in ours for k in COUNTERS
                       if k != "serialized_request_count")


def test_a_diverged_mirror_raises():
    """An agreed bit that the worker's mirror does not hold is a protocol
    fault, not something to renegotiate."""
    ctl = controller.Controller(ProcessTopology(rank=1, size=2, local_rank=1,
                                                local_size=2), object())
    with pytest.raises(controller.HorovodInternalError,
                       match="cache mirror diverged"):
        ctl._apply_reply(messages.MaskFrame(mask=b"\x04").to_bytes())


def test_an_abort_verdict_raises_its_reason_on_a_worker():
    ctl = controller.Controller(ProcessTopology(rank=1, size=2, local_rank=1,
                                                local_size=2), object())
    reason = "stall shutdown: tensor x incomplete for 3s (> 2.0s), " \
             "missing ranks [1]"
    with pytest.raises(controller.HorovodInternalError) as err:
        ctl._apply_reply(messages.AbortFrame(reason=reason).to_bytes())
    assert str(err.value) == reason


# ---------------------------------------------------------------------------
# (f) the launcher's runtime flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--cache-capacity", "512"],
    ["--no-stall-check"],
    ["--stall-check-warning-time-seconds", "7",
     "--stall-check-shutdown-time-seconds", "30"],
    ["--cache-capacity", "16", "--no-stall-check",
     "--stall-check-shutdown-time-seconds", "2"],
])
def test_launcher_flags_become_the_jax_environment(argv):
    command = ["-np", "2"] + argv + ["true"]
    ours = launch.runtime_env(launch.build_parser().parse_args(command))
    theirs = jax_config.env_from_args(
        jax_launch.build_parser().parse_args(command))
    assert ours == theirs and ours


def test_launcher_cache_capacity_zero_turns_the_cache_off():
    """``--cache-capacity 0`` reaches the ranks (the JAX mapping drops a
    0-valued flag, so the cache stays on there)."""
    args = launch.build_parser().parse_args(
        ["-np", "2", "--cache-capacity", "0", "true"])
    assert launch.runtime_env(args) == {"HOROVOD_CACHE_CAPACITY": "0"}
