"""The elastic driver: discovery loop, membership epochs, worker lifecycle.

The port's copy of ``horovod_tpu/elastic/driver.py`` (reference
``runner/elastic/driver.py:1-309``): a background thread polls discovery
every second (``DISCOVER_HOSTS_FREQUENCY_SECS``); a change of the host
set, a worker's exit, an expired lease, a worker's reset request or a
coordinator's demotion report advances the membership epoch; a host is
blacklisted after repeated failures; ranks stay stable for surviving
hosts.

Membership protocol:

1. every epoch the driver publishes a slot table (rank/local/cross + epoch)
   under ``rank_and_size/{hostname}:{local_rank}``, with its epoch, in one
   batch of the rendezvous server's store (``runner/rendezvous.py``);
2. workers (re)initialize from their identity's entry; removed identities
   see ``rank: -1`` and exit;
3. on a change: epoch += 1, publish, notify live workers with the NEW epoch
   (they raise ``HostsUpdatedInterrupt`` at the next commit; pings naming
   an epoch not newer than the worker's own are ignored as stale); spawn
   processes for new identities, which are acked at once (they are born at
   the new epoch);
4. a worker's death is recorded: crash exits blacklist the host after
   ``crash_failure_limit`` strikes, transient exits (the worker gave up
   re-initializing, ``TRANSIENT_EXIT_CODE``) after
   ``transient_failure_limit``; an identity whose process died on a
   healthy host is respawned at the next epoch.

The per-tick judgment is written as pure generators (``tick_read_steps``
... ``reshard_commit_steps``) over an abstract driver: each side effect is
one yielded step, which :class:`ElasticDriver` executes against the store,
the host manager and the clock.  The tests drive the JAX package's
generators and these with the same inputs.

Against a server in another process (``HOROVOD_RENDEZVOUS_EXTERNAL``) a
store op can fail.  A tick whose store ops fail puts the driver in its
store-outage mode: no lease expires and no epoch advances until the store
answers again, and then every lease gets one full timeout to show life
(:func:`outage_recovery_steps`): the workers could not renew through the
outage, and a restarted server's replayed leases are old.  A launcher
started again over a journaled server re-adopts the epoch and the live
workers from it (:meth:`ElasticDriver.recover_from_store`,
:func:`recover_steps`), and its first publish is fenced on the epoch it
read (a ``check`` op), so that a publish of an earlier incarnation that
lands in between is not overwritten with an older epoch.

With a timeline active (the launcher's ``<path>.driver``), the driver
writes ``DRV_WAIT`` (the loop's sleep), ``DRV_SPAWN`` (each worker's
spawn) and one ``CHURN_EVENT`` per epoch change, from the start of the
tick that saw the change to the end of the notify.

Two differences from the JAX driver.  The exit of a worker whose identity
no longer holds a rank (a removed host's worker leaving with 0) is not the
job's success, as in reference Horovod's ``_handle_worker_exit``; the JAX
driver counts it, and then refuses every later epoch.  A store error in
the middle of an epoch change puts the driver in its store-outage mode,
and the change is made again, at a newer epoch, once the store answers
(the table may not have landed); the JAX driver's discovery thread dies
on it.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..common import env as env_mod
from ..common import faults
from ..common.logging_util import get_logger
from ..core import flight_recorder
from ..core import metrics
from ..core import timeline as timeline_mod
from ..runner.hosts import SlotInfo, get_host_assignments
from ..transport.scopes import (
    DEMOTION_REPORT_SCOPE,
    DRIVER_SCOPE,
    EPOCH_ACK_SCOPE,
    LEASE_SCOPE,
    RANK_AND_SIZE_SCOPE,
    RESET_REQUEST_SCOPE,
    WORKERS_SCOPE,
)
from .constants import (
    DEFAULT_CRASH_FAILURE_LIMIT,
    DEFAULT_TRANSIENT_FAILURE_LIMIT,
    DISCOVER_HOSTS_FREQUENCY_SECS,
    ELASTIC_TIMEOUT_SECS,
    TRANSIENT_EXIT_CODE,
)
from .discovery import HostManager
from .registration import WorkerStateRegistry
from .worker import WorkerNotificationClient

log = get_logger("horovod_tpu_torch.elastic.driver")


# -- the per-tick judgment, as pure generators --------------------------------
#
# Step vocabulary (first element is the kind; the driver answers reads
# through ``generator.send``):
#
#   (STEP_TXN, ops, tag)          -> results   one batched store round-trip
#   (STEP_CLOCK,)                 -> float     monotonic clock read
#   (STEP_GRACE, until)                        arm the lease re-grace window
#   (STEP_BLACKLIST, host, rep)                shed a demoted host NOW —
#                                   strictly before this tick's host poll
#   (STEP_POLL_HOSTS,)            -> (changed, removal)   discovery poll
#   (STEP_GATE, which)            -> bool      advance gate ("success" /
#                                   "reset_limit" / "capacity"); True blocks
#   (STEP_EXPIRE, identity)                    drop a dead-leased identity
#   (STEP_ADVANCE, cause, removalish)          THE epoch advance (at most
#                                   one per judged tick, cause-tagged)

STEP_TXN = "txn"
STEP_CLOCK = "clock"
STEP_GRACE = "grace"
STEP_BLACKLIST = "blacklist"
STEP_POLL_HOSTS = "poll_hosts"
STEP_GATE = "gate"
STEP_EXPIRE = "expire"
STEP_ADVANCE = "advance"


def pending_reset_reasons(raws: Dict[str, object], epoch: int) -> List[str]:
    """Worker reset requests carrying the CURRENT epoch; anything older
    was answered by a later bump already and expires in place."""
    reasons = []
    for identity in sorted(raws or {}):
        raw = raws[identity]
        if raw is None:
            continue
        try:
            req = json.loads(bytes(raw).decode())
        except ValueError:
            continue
        if isinstance(req, dict) and req.get("epoch", -1) == epoch:
            reasons.append(
                f"{identity}: {req.get('reason', 'unspecified')}")
    return reasons


def parse_demotion_reports(raws: Optional[Dict[str, object]],
                           epoch: int) -> List[Dict[str, object]]:
    """Coordinator demotion reports for the CURRENT epoch (same staleness
    rule as reset requests); malformed payloads are skipped — this
    channel is advisory."""
    reports: List[Dict[str, object]] = []
    for identity in sorted(raws or {}):
        raw = raws[identity]
        if raw is None:
            continue
        try:
            rep = json.loads(bytes(raw).decode())
        except (ValueError, TypeError):
            continue
        if isinstance(rep, dict) and rep.get("epoch", -1) == epoch \
                and isinstance(rep.get("rank"), int):
            rep["reporter"] = identity
            reports.append(rep)
    return reports


def decide_cause(expired, demoted, reset_reasons, missing_workers) -> str:
    """Cause precedence, mirroring the judgment order: an expired lease
    explains the missing worker it produced, a demotion is a deliberate
    shed of a live-but-slow host, a reset request means everyone is
    alive, worker_exit is a death the exit monitor saw first,
    host_change is pure discovery movement."""
    return ("lease_expiry" if expired else
            "demotion" if demoted else
            "reset_request" if reset_reasons else
            "worker_exit" if missing_workers else "host_change")


def tick_read_steps(epoch: int, await_ack, slot_ids, removed, exited):
    """Coalesce one tick's store reads into ONE batched round-trip and
    unpack the results; returns the fetched dict (``epoch_ack`` /
    ``reset`` / ``demotion`` / ``lease`` maps keyed by identity).  A get
    of an absent key returns None, which every consumer treats as "not
    present", so no keys-then-intersect dance is needed."""
    slot_ids = sorted(slot_ids)
    ack_ids = None
    if await_ack is not None and epoch != 0:
        ids = set(slot_ids) | set(removed)
        ids -= set(exited)
        ack_ids = sorted(ids)
    ops: List[tuple] = []
    if ack_ids is not None:
        ops.extend(("get", EPOCH_ACK_SCOPE, i) for i in ack_ids)
    ops.extend(("get", RESET_REQUEST_SCOPE, i)
               for i in slot_ids)
    ops.extend(("get", DEMOTION_REPORT_SCOPE, i)
               for i in slot_ids)
    ops.extend(("get", LEASE_SCOPE, i) for i in slot_ids)
    results = yield (STEP_TXN, tuple(ops), "tick_reads")
    idx = 0
    out: Dict[str, Optional[Dict[str, object]]] = {"epoch_ack": None}
    if ack_ids is not None:
        out["epoch_ack"] = dict(
            zip(ack_ids, results[idx:idx + len(ack_ids)]))
        idx += len(ack_ids)
    out["reset"] = dict(zip(slot_ids, results[idx:idx + len(slot_ids)]))
    idx += len(slot_ids)
    out["demotion"] = dict(
        zip(slot_ids, results[idx:idx + len(slot_ids)]))
    idx += len(slot_ids)
    out["lease"] = dict(zip(slot_ids, results[idx:]))
    return out


def scan_lease_steps(raws: Dict[str, object],
                     lease_seen: Dict[str, Tuple[bytes, float]],
                     grace_until: float, lease_timeout: float):
    """Judge lease freshness: time-since-last-VALUE-CHANGE on the clock
    this generator reads (worker clocks never enter the judgment), with
    no expiry before ``grace_until``.  Mutates ``lease_seen`` in place
    (it IS the driver's tracking dict).  Returns ``(expired, min_ttl)``;
    identities that never posted a lease are exempt."""
    now = yield (STEP_CLOCK,)
    identities = set(raws)
    expired: Set[str] = set()
    min_ttl: Optional[float] = None
    for identity in sorted(raws):
        raw = raws[identity]
        if raw is None:
            continue
        seen = lease_seen.get(identity)
        if seen is None or seen[0] != raw:
            lease_seen[identity] = (raw, now)
            ttl = lease_timeout  # fresh renewal: full budget
        else:
            ttl = lease_timeout - (now - seen[1])
            if now >= grace_until and now - seen[1] > lease_timeout:
                expired.add(identity)
        if min_ttl is None or ttl < min_ttl:
            min_ttl = ttl
    # Drop tracking for identities that left the slot table.
    for identity in list(lease_seen):
        if identity not in identities:
            del lease_seen[identity]
    return expired, min_ttl


def tick_judgment_steps(epoch: int, fetched: Dict[str, object],
                        rank_to_host: Dict[int, str],
                        known_identities, slot_identities,
                        lease_seen, grace_until: float,
                        lease_timeout: float):
    """One judged tick, from a successful fetch to the advance decision.

    The orderings live HERE: demotion blacklists are
    yielded strictly before the discovery poll (so a shed host drops out
    of this very tick's host set), expiries before the missing-worker
    computation, the gates before the advance, and STEP_ADVANCE at most
    once.  Returns the judgment record (cause, removalish, expired,
    missing, plus bookkeeping for logs/metrics)."""
    reset_reasons = pending_reset_reasons(fetched["reset"], epoch)
    reports = parse_demotion_reports(fetched["demotion"], epoch)
    expired, min_ttl = yield from scan_lease_steps(
        fetched["lease"], lease_seen, grace_until, lease_timeout)
    demoted: List[str] = []
    unresolvable: List[int] = []
    for rep in reports:
        rank = rep["rank"]
        host = rank_to_host.get(rank) or rep.get("hostname")
        if not isinstance(host, str) or not host:
            unresolvable.append(rank)
            continue
        # Blacklist BEFORE the discovery poll, never after.
        yield (STEP_BLACKLIST, host, rep)
        demoted.append(f"rank {rank}@{host}")
    changed, removal = yield (STEP_POLL_HOSTS,)
    j = {
        "advanced": False, "cause": None, "removalish": False,
        "removal": removal, "expired": expired, "missing": set(),
        "reset_reasons": reset_reasons, "demoted": demoted,
        "unresolvable": unresolvable, "min_ttl": min_ttl,
        "leases_live": len(lease_seen) - len(expired), "blocked": None,
    }
    if (yield (STEP_GATE, "success")):
        # Winding down: never rendezvous a new epoch once a worker
        # finished — a fresh slot table would assign a rank to the
        # dead-but-successful identity and hang the survivors' mesh.
        j["blocked"] = "success"
        return j
    for identity in sorted(expired):
        # Expired with the store REACHABLE: genuinely dead (or wedged
        # past saving) — drop it so the missing-workers path advances
        # the epoch THIS tick, cause-tagged lease_expiry.
        yield (STEP_EXPIRE, identity)
    missing = set(slot_identities) - (set(known_identities) - expired)
    j["missing"] = missing
    if not changed and not missing and not reset_reasons and not demoted:
        return j
    if (yield (STEP_GATE, "reset_limit")):
        j["blocked"] = "reset_limit"
        return j
    if (yield (STEP_GATE, "capacity")):
        j["blocked"] = "capacity"
        return j
    # A worker-initiated reset (e.g. corruption abort with every process
    # still alive) is removal-LIKE for sync purposes: the workers rolled
    # back and must state.sync() after the reset.
    removalish = removal or bool(missing) or bool(reset_reasons) \
        or bool(demoted)
    cause = decide_cause(expired, demoted, reset_reasons, missing)
    yield (STEP_ADVANCE, cause, removalish)
    j.update(advanced=True, cause=cause, removalish=removalish)
    return j


def reshard_plan(table: Dict[str, dict], known_identities,
                 enabled: bool, pending: Optional[dict],
                 recent_joiners=()) -> Dict[str, object]:
    """Pure reshard judgment for one epoch publish.

    ``table`` is the slot table about to be published; ``known_identities``
    is the set of identities with a live worker process from the previous
    epoch (the spawn loop's exact complement: everything ranked but not
    known gets spawned).  ``survivors`` are the process-keeping ranked
    identities — the set whose epoch acks gate the commit.  ``joiners``
    (the sync targets) are the about-to-be-spawned identities PLUS any
    survivor that was itself a joiner of the immediately previous epoch
    (``recent_joiners``): its ack proves adoption, not a completed state
    sync, so until an epoch with it as a plain survivor commits it may
    still hold blank init state.  ``sync_root`` is therefore the lowest
    rank among SEASONED survivors only — rank 0 itself may be the fresh
    process being state-filled, and a recent joiner as root could
    broadcast blank state over everyone's progress.  No seasoned
    survivor ⇒ not eligible (legacy full sync from rank 0).

    The fallback rule is load-bearing: while a previous reshard is
    ``pending`` (published but never survivor-acked to commit — a
    survivor crashed mid-reshard), the NEXT publish must NOT carry the
    marker, degrading those workers to the legacy full-teardown path."""
    keepers = sorted(i for i, s in table.items()
                     if s["rank"] >= 0 and i in known_identities)
    spawning = sorted(i for i, s in table.items()
                      if s["rank"] >= 0 and i not in known_identities)
    recent = set(recent_joiners)
    seasoned = [i for i in keepers if i not in recent]
    joiners = sorted(set(spawning) | (set(keepers) & recent))
    fallback = pending is not None
    eligible = enabled and bool(seasoned) and not fallback
    sync_root = min((table[i]["rank"] for i in seasoned), default=0)
    return {"eligible": eligible, "fallback": fallback,
            "survivors": keepers, "joiners": joiners,
            "sync_root": sync_root}


def reshard_commit_steps(epoch: int, survivors):
    """One commit-probe of a pending zero-restart reshard.

    The ordering lives HERE: the durable commit record
    is written ONLY after every listed survivor's epoch ack for ``epoch``
    is readable in the store: a crash after an earlier commit would adopt
    a topology some survivor never agreed to rejoin.  Returns ``{"committed", "missing"}``; the
    caller re-probes next tick while survivors are still rendezvousing,
    and an epoch ADVANCE while still missing is the fallback path."""
    if not survivors:
        return {"committed": False, "missing": []}
    acks = yield (STEP_TXN,
                  tuple(("get", EPOCH_ACK_SCOPE, i) for i in survivors),
                  "reshard_acks")
    missing = []
    for identity, raw in zip(survivors, acks):
        try:
            acked = int(bytes(raw).decode()) if raw is not None else -1
        except ValueError:
            acked = -1
        if acked < epoch:
            missing.append(identity)
    if missing:
        return {"committed": False, "missing": missing}
    yield (STEP_TXN,
           (("set", DRIVER_SCOPE, "reshard_commit", str(epoch).encode()),),
           "reshard_commit")
    return {"committed": True, "missing": []}


def outage_recovery_steps(lease_timeout: float):
    """On the first successful fetch after a store outage: the workers could
    not renew through it (their renewals go to the same store), so the
    judgment clock restarts and every lease gets one full timeout before
    it may expire.  Without this re-grace a restarted server's replayed
    leases read as expired at once, and a live worker is shed."""
    now = yield (STEP_CLOCK,)
    yield (STEP_GRACE, now + lease_timeout)


def recover_steps(lease_timeout: float):
    """A restarted driver's adoption: the durable epoch, and the identities
    with a lease whose slot entry holds a rank at that epoch, then the
    re-grace (the replayed lease values are old).  Returns None when the
    store holds no epoch, else ``{"epoch", "adopted"}`` with ``adopted``
    mapping identity -> (slot dict, lease value)."""
    res = yield (STEP_TXN, (("get", DRIVER_SCOPE, "epoch"),),
                 "recover_epoch")
    raw = res[0]
    if raw is None:
        return None
    epoch = int(bytes(raw).decode())
    leased = (yield (STEP_TXN, (("keys", LEASE_SCOPE),),
                     "recover_lease_keys"))[0]
    fetch_ops: List[tuple] = []
    for identity in leased:
        fetch_ops.append(("get", LEASE_SCOPE, identity))
        fetch_ops.append(("get", RANK_AND_SIZE_SCOPE, identity))
    fetched: List[object] = []
    if fetch_ops:
        fetched = yield (STEP_TXN, tuple(fetch_ops), "recover_slots")
    adopted: Dict[str, Tuple[dict, object]] = {}
    for i, identity in enumerate(leased):
        lease, slot_raw = fetched[2 * i], fetched[2 * i + 1]
        if lease is None or slot_raw is None:
            continue
        try:
            slot = json.loads(bytes(slot_raw).decode())
        except ValueError:
            continue
        if slot.get("rank", -1) < 0 or slot.get("epoch", -1) != epoch:
            continue
        adopted[identity] = (slot, lease)
    now = yield (STEP_CLOCK,)
    yield (STEP_GRACE, now + lease_timeout)
    return {"epoch": epoch, "adopted": adopted}


class ElasticDriver:
    #: What a store op raises when the server is down or restarting: the
    #: HTTP client's connection errors, all ``OSError``.  The in-process
    #: server never raises them.
    _STORE_ERRORS = OSError

    def __init__(self, rendezvous, host_manager: HostManager,
                 min_np: int, max_np: Optional[int] = None,
                 reset_limit: Optional[int] = None,
                 timeout: float = ELASTIC_TIMEOUT_SECS,
                 crash_failure_limit: Optional[int] = None,
                 transient_failure_limit: Optional[int] = None,
                 lease_timeout: Optional[float] = None):
        self.rendezvous = rendezvous
        self.hosts = host_manager
        self.min_np = min_np
        self.max_np = max_np
        self.reset_limit = reset_limit
        self.timeout = timeout
        self.epoch = 0
        self.resets = 0
        self.stopped_error: Optional[str] = None
        self.crash_failure_limit = crash_failure_limit if crash_failure_limit \
            is not None else env_mod.get_int(
                env_mod.HOROVOD_ELASTIC_CRASH_FAILURE_LIMIT,
                DEFAULT_CRASH_FAILURE_LIMIT)
        self.transient_failure_limit = transient_failure_limit \
            if transient_failure_limit is not None else env_mod.get_int(
                env_mod.HOROVOD_ELASTIC_TRANSIENT_FAILURE_LIMIT,
                DEFAULT_TRANSIENT_FAILURE_LIMIT)
        self._crash_failures: Dict[str, int] = defaultdict(int)
        self._transient_failures: Dict[str, int] = defaultdict(int)
        self._slots: List[SlotInfo] = []
        self._known_identities: Dict[str, SlotInfo] = {}
        self._create_worker: Optional[Callable[[SlotInfo, int], None]] = None
        self.registry = WorkerStateRegistry(0)
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._wakeup = threading.Event()
        self._discovery_thread: Optional[threading.Thread] = None
        self._await_ack: Optional[bool] = None  # added_only flavor, or None
        self._removed_identities: set = set()
        self._exited_identities: set = set()
        # (reporter identity, epoch, rank) demotions already counted: a
        # current-epoch report stays readable until the epoch advances.
        self._demotion_seen: Set[Tuple[str, int, int]] = set()
        # Once a worker succeeds the job is winding down: a finished
        # identity must never be handed a rank in a fresh epoch (reference
        # registration.py:139-143).
        self._success = False
        # -- leases: identity -> (last value seen, monotonic time it
        # changed); no lease expires before the grace deadline.
        self.lease_timeout = lease_timeout if lease_timeout is not None \
            else env_mod.get_float(env_mod.HOROVOD_LEASE_TIMEOUT_SECS,
                                   env_mod.DEFAULT_LEASE_TIMEOUT_SECS)
        self._lease_seen: Dict[str, Tuple[bytes, float]] = {}
        self._lease_grace_until = 0.0
        # Monotonic time the store stopped answering, or None.
        self._store_outage_since: Optional[float] = None
        # Set when the store failed during an epoch change: the table may
        # not have landed, so the change is made again, at a newer epoch,
        # once the store answers.
        self._readvance = False
        # -- resharding: the published but uncommitted reshard ({"epoch",
        # "survivors", "published_ns", "missing"}), and the joiners of the
        # last marked publish (see reshard_plan).
        self.reshard_enabled = env_mod.get_bool(env_mod.HOROVOD_RESHARD,
                                                True)
        self._reshard_pending: Optional[dict] = None
        self._last_reshard_joiners: set = set()
        # The epoch recover_from_store adopted (None: a fresh start), which
        # the initial publish fences on.
        self._recovered_epoch: Optional[int] = None

    # ------------------------------------------------------------------

    def wait_for_available_slots(self, min_np: Optional[int] = None) -> None:
        """Block until discovery provides enough slots (reference
        ``driver.py:145``)."""
        need = min_np or self.min_np
        deadline = time.monotonic() + self.timeout
        while True:
            self.hosts.update_available_hosts()
            if self.hosts.total_slots() >= need:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out waiting for {need} slots "
                    f"(have {self.hosts.total_slots()})")
            time.sleep(DISCOVER_HOSTS_FREQUENCY_SECS)

    def start(self, create_worker: Callable[[SlotInfo, int], None]) -> None:
        """Publish epoch 0's assignments, spawn the workers, start the
        discovery loop."""
        self._create_worker = create_worker
        self.wait_for_available_slots()
        for attempt in range(5):
            if self._rendezvous_epoch(initial=True):
                break
            # The fence failed: an earlier incarnation's publish landed
            # after our recovery read.  Adopt again and publish at its epoch.
            log.warning("the initial epoch publish lost its fence (attempt "
                        "%d); adopting the driver's state from the store "
                        "again", attempt + 1)
            self.recover_from_store()
        else:
            raise RuntimeError(
                "could not fence the initial epoch publish in 5 attempts: "
                "the store's epoch keeps moving")
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, name="hvd-elastic-discovery",
            daemon=True)
        self._discovery_thread.start()

    def stop(self, error_message: Optional[str] = None) -> None:
        if error_message and not self.stopped_error:
            self.stopped_error = error_message
        self._shutdown.set()
        self._wakeup.set()

    # ------------------------------------------------------------------

    def _assignments(self) -> List[SlotInfo]:
        hosts = self.hosts.current_hosts
        total = sum(h.slots for h in hosts)
        np_ = min(total, self.max_np) if self.max_np else total
        return get_host_assignments(hosts, min(self.min_np, np_), np_)

    def _rendezvous_epoch(self, initial: bool = False) -> bool:
        """Publish the epoch's table and spawn its new identities.  False
        when the initial publish lost its fence (nothing was written)."""
        with self._lock:
            if not initial:
                self.epoch += 1
                self.resets += 1
            new_slots = self._assignments()
            self._slots = new_slots
            self.registry.reset(len(new_slots))
            # The new table; removed identities get rank -1, so that a
            # surviving process on a removed host exits cleanly.
            table = {}
            for s in new_slots:
                table[f"{s.hostname}:{s.local_rank}"] = {
                    "hostname": s.hostname, "rank": s.rank,
                    "local_rank": s.local_rank, "cross_rank": s.cross_rank,
                    "size": s.size, "local_size": s.local_size,
                    "cross_size": s.cross_size, "epoch": self.epoch,
                }
            for identity in self._known_identities:
                if identity not in table:
                    host, lr = identity.rsplit(":", 1)
                    table[identity] = {
                        "hostname": host, "rank": -1, "local_rank": int(lr),
                        "cross_rank": -1, "size": 0, "local_size": 0,
                        "cross_size": 0, "epoch": self.epoch,
                    }
            plan = reshard_plan(
                table, set(self._known_identities),
                enabled=self.reshard_enabled and not initial,
                pending=self._reshard_pending,
                recent_joiners=self._last_reshard_joiners)
            if plan["fallback"]:
                failed = self._reshard_pending
                self._reshard_pending = None
                metrics.inc("reshard_fallbacks_total")
                flight_recorder.record(
                    "reshard_fallback", epoch=self.epoch,
                    pending_epoch=failed["epoch"],
                    missing=sorted(failed.get("missing") or []))
                log.warning(
                    "reshard for epoch %d never committed (unacked: %s); "
                    "epoch %d falls back to the full sync",
                    failed["epoch"], sorted(failed.get("missing") or []),
                    self.epoch)
            if plan["eligible"]:
                for slot in table.values():
                    slot["reshard"] = True
                    slot["sync_root"] = plan["sync_root"]
                    slot["joiners"] = plan["joiners"]
                    slot["survivors"] = plan["survivors"]
            # The whole table and the epoch in one batch: no worker reads
            # half of a table, and a restarted driver adopts this epoch.
            publish_ops = [
                ("set", RANK_AND_SIZE_SCOPE, identity,
                 json.dumps(slot).encode())
                for identity, slot in table.items()]
            publish_ops.append(("set", DRIVER_SCOPE, "epoch",
                                str(self.epoch).encode()))
            if initial:
                # Fenced on the adopted epoch (absent on a fresh start).
                expected = None if self._recovered_epoch is None \
                    else str(self._recovered_epoch).encode()
                publish_ops.insert(
                    0, ("check", DRIVER_SCOPE, "epoch", expected))
            if plan["eligible"]:
                # Armed before the publish: a store error does not prove
                # that the marked table never landed, and a pending reshard
                # whose marker never landed is never acked, so the next
                # advance falls back.
                self._reshard_pending = {
                    "epoch": self.epoch,
                    "survivors": plan["survivors"],
                    "published_ns": time.monotonic_ns(),
                    "missing": list(plan["survivors"]),
                }
                self._last_reshard_joiners = set(plan["joiners"])
            else:
                self._last_reshard_joiners = set()
            results = self.rendezvous.batch(publish_ops)
            if initial and results and results[0] is False:
                return False
            if plan["eligible"]:
                flight_recorder.record(
                    "reshard_publish", epoch=self.epoch,
                    survivors=plan["survivors"], joiners=plan["joiners"],
                    sync_root=plan["sync_root"])
                log.info("epoch %d published with reshard marker "
                         "(%d survivors, %d joiners, sync_root=%d)",
                         self.epoch, len(plan["survivors"]),
                         len(plan["joiners"]), plan["sync_root"])
            # Spawn processes for identities that have none yet; each is
            # born at this epoch, so it is acked at once (it never passes
            # through refresh_topology_from_rendezvous, where acks are
            # written), else the re-notify would ping it forever.
            ack_ops = []
            for s in new_slots:
                identity = f"{s.hostname}:{s.local_rank}"
                if identity not in self._known_identities:
                    log.info("spawning worker %s (epoch %d, rank %d)",
                             identity, self.epoch, s.rank)
                    # A lease left by an earlier process of this identity
                    # would start the new one's clock at its spawn, before
                    # it could renew: the new process is exempt until it
                    # first renews, as at the job's start.
                    self.rendezvous.delete(LEASE_SCOPE, identity)
                    self._lease_seen.pop(identity, None)
                    t_spawn = time.monotonic_ns() \
                        if timeline_mod.control_active() else None
                    self._create_worker(s, self.epoch)
                    if t_spawn is not None:
                        timeline_mod.control_span_since(
                            "driver", "DRV_SPAWN", t_spawn,
                            identity=identity, epoch=self.epoch)
                    self._exited_identities.discard(identity)
                    ack_ops.append(("set", EPOCH_ACK_SCOPE, identity,
                                    str(self.epoch).encode()))
                self._known_identities[identity] = s
            if ack_ops:
                self.rendezvous.batch(ack_ops)
            current = {f"{s.hostname}:{s.local_rank}" for s in new_slots}
            self._removed_identities = {
                i for i in self._known_identities if i not in current}
            for identity in self._removed_identities:
                self._known_identities.pop(identity)
            return True

    def _notify_workers(self, added_only: bool,
                        identities: Optional[set] = None,
                        reshard: bool = False) -> None:
        if identities is None:
            # Removed identities too: the ping makes their worker read
            # rank -1 and exit promptly.
            identities = {f"{s.hostname}:{s.local_rank}" for s in self._slots}
            identities.update(self._removed_identities)
        ordered = sorted(identities)
        raws = self.rendezvous.batch(
            [("get", WORKERS_SCOPE, identity) for identity in ordered])
        addresses = []
        missing = []
        for identity, raw in zip(ordered, raws):
            if raw:
                addresses.append(bytes(raw).decode())
            else:
                missing.append(identity)
        log.info("notifying %d workers of host change at epoch %d "
                 "(unregistered: %s)", len(addresses), self.epoch,
                 missing or "none")
        WorkerNotificationClient(addresses).notify_hosts_updated(
            added_only, epoch=self.epoch, reshard=reshard)

    def _discovery_loop(self) -> None:
        while not self._shutdown.is_set():
            t_wait = time.monotonic_ns() \
                if timeline_mod.control_active() else None
            self._wakeup.wait(DISCOVER_HOSTS_FREQUENCY_SECS)
            if t_wait is not None:
                timeline_mod.control_span_since("driver", "DRV_WAIT", t_wait)
            self._wakeup.clear()
            if self._shutdown.is_set():
                return
            # Outside the tick's timing: action=raise kills this thread (a
            # wedged driver), exit the launcher.
            if faults.ACTIVE:
                faults.inject("driver.tick")
            t0 = time.monotonic_ns()
            try:
                self._tick(t0)
            except self._STORE_ERRORS as e:
                self._store_outage(e)
                self._readvance = True
            finally:
                metrics.observe("driver_tick_seconds",
                                (time.monotonic_ns() - t0) / 1e9)

    def _tick(self, t0_ns: Optional[int] = None) -> None:
        """One discovery tick: the batched reads, the re-notify of unacked
        workers and the reshard commit probe, then the judgment kernel
        against the live host manager and clock.  A store error in the
        first part means that the store is down, not that workers died:
        the tick ends in the store-outage mode.  ``t0_ns`` (default now)
        starts the CHURN_EVENT span when the tick advances the epoch."""
        if t0_ns is None:
            t0_ns = time.monotonic_ns()
        try:
            fetched = self._tick_store_reads()
            self._renotify_unacked(fetched.get("epoch_ack"))
            self._store_recovered()
            self._reshard_commit_probe()
        except self._STORE_ERRORS as e:
            self._store_outage(e)
            return
        if self._readvance:
            self._readvance = False
            self._advance("store_outage", True, removal=False, missing=set(),
                          reset_reasons=[], demoted=[], t0_ns=t0_ns)
            return
        with self._lock:
            rank_to_host = {s.rank: s.hostname for s in self._slots}
            slot_identities = {f"{s.hostname}:{s.local_rank}"
                               for s in self._slots}
            known = set(self._known_identities)
        steps = tick_judgment_steps(
            self.epoch, fetched, rank_to_host, known, slot_identities,
            self._lease_seen, self._lease_grace_until, self.lease_timeout)
        resp = None
        while True:
            try:
                step = steps.send(resp)
            except StopIteration as fin:
                j = fin.value
                break
            kind = step[0]
            resp = None
            if kind == STEP_CLOCK:
                resp = time.monotonic()
            elif kind == STEP_BLACKLIST:
                self._blacklist_for_demotion(step[1], step[2])
            elif kind == STEP_POLL_HOSTS:
                try:
                    resp = self.hosts.update_available_hosts()
                except Exception as e:  # noqa: BLE001 — a discovery
                    # script's hiccup must not kill the judgment loop
                    log.warning("host discovery failed: %s", e)
                    steps.close()
                    return
            elif kind == STEP_GATE:
                resp = self._judgment_gate(step[1])
            elif kind == STEP_EXPIRE:
                self._expire_identity(step[1])
            # STEP_ADVANCE is the last yield; the advance below consumes
            # the returned judgment.
        for rank in j["unresolvable"]:
            log.warning("demotion report for rank %s names no "
                        "resolvable host; ignoring", rank)
        metrics.set_gauge("leases_live", j["leases_live"])
        if j["min_ttl"] is not None:
            metrics.set_gauge("lease_min_ttl_seconds", j["min_ttl"])
        if j["expired"]:
            metrics.inc("lease_expirations_total", len(j["expired"]))
        if not j["advanced"]:
            return
        self._advance(j["cause"], j["removalish"], removal=j["removal"],
                      missing=j["missing"], reset_reasons=j["reset_reasons"],
                      demoted=j["demoted"], t0_ns=t0_ns)

    def _advance(self, cause: str, removalish: bool, removal, missing,
                 reset_reasons, demoted, t0_ns: int) -> None:
        """The epoch change: publish, notify, record."""
        log.info("host set changed (removal=%s, dead_workers=%s, "
                 "reset_requests=%s, demotions=%s, cause=%s); "
                 "advancing epoch", removal, sorted(missing),
                 reset_reasons, demoted, cause)
        self._rendezvous_epoch()
        self._await_ack = not removalish  # the flavor, for the re-notify
        self._notify_workers(added_only=not removalish,
                             reshard=self._reshard_pending is not None)
        metrics.inc("driver_epoch_transitions_total", cause=cause)
        flight_recorder.record(
            "epoch_transition", epoch=self.epoch, cause=cause,
            removal=removal, dead_workers=sorted(missing),
            reset_requests=reset_reasons, demotions=demoted)
        if timeline_mod.control_active():
            timeline_mod.control_span_since(
                "driver", "CHURN_EVENT", t0_ns, epoch=self.epoch, cause=cause)
            timeline_mod.control_instant(
                "driver", "EPOCH_TRANSITION", epoch=self.epoch, cause=cause)

    def _judgment_gate(self, which: str) -> bool:
        """Answer one STEP_GATE: True blocks this tick's advance."""
        if which == "success":
            with self._lock:
                return self._success
        if which == "reset_limit":
            if self.reset_limit is not None and \
                    self.resets >= self.reset_limit:
                msg = (f"elastic reset limit {self.reset_limit} reached; "
                       "stopping job (reference RESET_LIMIT_EXCEEDED)")
                log.error(msg)
                self.stop(error_message=msg)
                return True
            return False
        if self.hosts.total_slots() < self.min_np:
            log.warning("host change leaves fewer than min_np slots; "
                        "waiting for capacity")
            return True
        return False

    def _expire_identity(self, identity: str) -> None:
        """Execute one STEP_EXPIRE: drop a dead-leased identity, so that
        the missing-workers path advances the epoch this tick."""
        log.warning("worker %s lease expired (no renewal in %.0fs); "
                    "declaring dead", identity, self.lease_timeout)
        with self._lock:
            self._known_identities.pop(identity, None)
            self._lease_seen.pop(identity, None)

    def _blacklist_for_demotion(self, host: str,
                                rep: Dict[str, object]) -> None:
        """Execute one STEP_BLACKLIST: shed the demoted host and record the
        evidence once per (reporter, epoch, rank)."""
        rank = rep["rank"]
        evidence = (f"rank {rank} readiness-lag EWMA {rep.get('ewma')}s "
                    f"over demote threshold {rep.get('threshold')}s for "
                    f"{rep.get('cycles')} consecutive busy cycles")
        new_strike = self.hosts.blacklist(host, evidence=evidence)
        key = (str(rep.get("reporter")), self.epoch, rank)
        if key not in self._demotion_seen:
            self._demotion_seen.add(key)
            metrics.inc("straggler_demotions_total", rank=str(rank),
                        host=host)
            posted = rep.get("posted_unix")
            if isinstance(posted, (int, float)):
                metrics.observe("demotion_latency_seconds",
                                max(0.0, time.time() - posted))
            flight_recorder.record(
                "demotion", epoch=self.epoch, rank=rank, host=host,
                ewma=rep.get("ewma"), new_strike=new_strike,
                reporter=rep.get("reporter"))
            log.warning("demoting host %s: %s", host, evidence)

    def _reshard_commit_probe(self) -> None:
        """One commit probe of the pending reshard
        (:func:`reshard_commit_steps`); missing acks carry to the next
        tick."""
        pending = self._reshard_pending
        if pending is None:
            return
        res = self._drive_txn_steps(reshard_commit_steps(
            pending["epoch"], pending["survivors"]))
        pending["missing"] = res["missing"]
        if not res["committed"]:
            return
        self._reshard_pending = None
        elapsed = (time.monotonic_ns() - pending["published_ns"]) / 1e9
        metrics.observe("reshard_seconds", elapsed)
        metrics.inc("driver_epoch_transitions_total", cause="reshard")
        flight_recorder.record(
            "reshard_commit", epoch=pending["epoch"],
            survivors=pending["survivors"], seconds=round(elapsed, 6))
        log.info("reshard committed at epoch %d (%d survivors, %.3fs "
                 "publish-to-commit)", pending["epoch"],
                 len(pending["survivors"]), elapsed)

    def _tick_store_reads(self) -> Dict[str, Optional[Dict[str, object]]]:
        """This tick's store reads in one batch (:func:`tick_read_steps`)."""
        with self._lock:
            slot_ids = sorted({f"{s.hostname}:{s.local_rank}"
                               for s in self._slots})
            removed = set(self._removed_identities)
            exited = set(self._exited_identities)
            await_ack = self._await_ack
        return self._drive_txn_steps(tick_read_steps(
            self.epoch, await_ack, slot_ids, removed, exited))

    def _drive_txn_steps(self, steps):
        """Execute a generator whose only step kind is STEP_TXN, answering
        each with one batch on the store."""
        resp = None
        while True:
            try:
                step = steps.send(resp)
            except StopIteration as fin:
                return fin.value
            assert step[0] == STEP_TXN, step
            resp = self.rendezvous.batch(list(step[1]))

    def _store_outage(self, err: Exception) -> None:
        if self._store_outage_since is None:
            self._store_outage_since = time.monotonic()
            log.warning("rendezvous store unreachable (%s); no membership "
                        "change until it answers again", err)

    def _store_recovered(self) -> None:
        """After an outage: the re-grace of :func:`outage_recovery_steps`."""
        if self._store_outage_since is None:
            return
        outage = time.monotonic() - self._store_outage_since
        self._store_outage_since = None
        steps = outage_recovery_steps(self.lease_timeout)
        resp = None
        while True:
            try:
                step = steps.send(resp)
            except StopIteration:
                break
            resp = None
            if step[0] == STEP_CLOCK:
                resp = time.monotonic()
            elif step[0] == STEP_GRACE:
                self._lease_grace_until = step[1]
        log.info("rendezvous store reachable again after %.1fs; lease "
                 "clocks re-graced for %.0fs", outage, self.lease_timeout)

    def recover_from_store(self) -> bool:
        """Before :meth:`start`: adopt an earlier incarnation's epoch and
        live workers from a journaled store (:func:`recover_steps`), so
        that ``start()`` publishes the same epoch and spawns only the
        identities with no live worker.  Returns whether there was state
        to adopt."""
        try:
            steps = recover_steps(self.lease_timeout)
            resp = None
            while True:
                try:
                    step = steps.send(resp)
                except StopIteration as fin:
                    recovered = fin.value
                    break
                resp = None
                if step[0] == STEP_TXN:
                    resp = self.rendezvous.batch(list(step[1]))
                elif step[0] == STEP_CLOCK:
                    resp = time.monotonic()
                elif step[0] == STEP_GRACE:
                    self._lease_grace_until = step[1]
        except (self._STORE_ERRORS, ValueError) as e:
            log.warning("driver state recovery failed (%s); starting at "
                        "epoch 0", e)
            self._recovered_epoch = None
            return False
        if recovered is None:
            self._recovered_epoch = None
            return False
        self.epoch = recovered["epoch"]
        self._recovered_epoch = recovered["epoch"]
        now = time.monotonic()
        with self._lock:
            for identity, (slot, lease) in recovered["adopted"].items():
                self._known_identities[identity] = SlotInfo(
                    hostname=slot["hostname"], rank=slot["rank"],
                    local_rank=slot["local_rank"],
                    cross_rank=slot["cross_rank"], size=slot["size"],
                    local_size=slot["local_size"],
                    cross_size=slot["cross_size"])
                self._lease_seen[identity] = (lease, now)
        log.info("recovered the driver's state from the store: epoch %d, "
                 "live workers %s", self.epoch,
                 sorted(recovered["adopted"]) or "(none)")
        return True

    def _renotify_unacked(
            self, acks: Optional[Dict[str, object]] = None) -> None:
        """A ping can race a worker's start (it registers its address just
        after the change fired): until every current identity acks the
        epoch, ping the UNACKED ones each tick.  ``acks`` is the tick's
        batched read (identity -> raw ack)."""
        if self._await_ack is None or self.epoch == 0 or acks is None:
            return
        unacked = {identity for identity, raw in acks.items()
                   if raw is None or int(bytes(raw).decode()) < self.epoch}
        if not unacked:
            self._await_ack = None
            return
        self._notify_workers(added_only=self._await_ack, identities=unacked,
                             reshard=self._reshard_pending is not None)

    def record_worker_exit(self, slot: SlotInfo, exit_code: int) -> None:
        """Called by the launcher's monitor of each worker (reference
        ``_handle_worker_exit``, ``driver.py:292-308``).  Crash exits count
        toward a low blacklist threshold, ``TRANSIENT_EXIT_CODE`` exits
        toward a higher one: the survivor of another rank's crash must not
        poison its own host.  The exit of a worker whose identity holds no
        rank at this epoch (it was removed) is ignored, as the reference
        does."""
        if self._shutdown.is_set():
            return
        identity = f"{slot.hostname}:{slot.local_rank}"
        with self._lock:
            self._exited_identities.add(identity)
            if identity not in {f"{s.hostname}:{s.local_rank}"
                                for s in self._slots}:
                log.info("worker %s, removed from the job, exited %d",
                         identity, exit_code)
                self._known_identities.pop(identity, None)
                return
        if exit_code == 0:
            self.registry.record_success(slot.rank)
            with self._lock:
                self._success = True
                # A clean exit clears the host's record.
                self._crash_failures.pop(slot.hostname, None)
                self._transient_failures.pop(slot.hostname, None)
            return
        self.registry.record_failure(slot.rank)
        transient = exit_code == TRANSIENT_EXIT_CODE
        with self._lock:
            counters = self._transient_failures if transient \
                else self._crash_failures
            counters[slot.hostname] += 1
            strikes = counters[slot.hostname]
            limit = self.transient_failure_limit if transient \
                else self.crash_failure_limit
            if strikes >= limit:
                self.hosts.blacklist(slot.hostname)
            else:
                log.warning("worker %s exited %d (%s, strike %d/%d); host "
                            "stays eligible", identity, exit_code,
                            "transient" if transient else "crash",
                            strikes, limit)
            self._known_identities.pop(identity, None)
        self._wakeup.set()

    @property
    def current_slots(self) -> List[SlotInfo]:
        with self._lock:
            return list(self._slots)
