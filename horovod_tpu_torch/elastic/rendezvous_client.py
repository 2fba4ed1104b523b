"""Worker-side re-rendezvous: fetch the current slot assignment, and the
worker -> driver posts.

The port's copy of ``horovod_tpu/elastic/rendezvous_client.py``, over the
HTTP rendezvous server (``runner/rendezvous.py``) through
``transport/store.py::HTTPStoreClient``.  A post that fails because the
server is down (an ``OSError``) is retried where the caller loops (the
lease renewals, the slot-table reads) and is best-effort elsewhere, so no
worker raises or exits for an outage shorter than the lease timeout.
Reference: ``gloo_context.cc:154-189`` — on elastic re-init the
worker asks the ``rank_and_size`` scope for its new rank and size, keyed by
``hostname:local_rank``; a removed host gets rank -1 and exits.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError
from ..common.logging_util import get_logger
from ..common.topology import ProcessTopology
from ..core import flight_recorder, metrics
from ..transport.scopes import (
    DEMOTION_REPORT_SCOPE,
    EPOCH_ACK_SCOPE,
    LEASE_SCOPE,
    METRICS_SCOPE,
    RANK_AND_SIZE_SCOPE,
    RESET_REQUEST_SCOPE,
)
from ..transport.store import HTTPStoreClient

log = get_logger("horovod_tpu_torch.elastic.rendezvous_client")


def identity() -> str:
    """This worker's key in every elastic scope: ``hostname:local_rank``."""
    hostname = env_mod.get_str(env_mod.HOROVOD_HOSTNAME) or "localhost"
    local_rank = env_mod.get_int(env_mod.HOROVOD_LOCAL_RANK, 0)
    return f"{hostname}:{local_rank}"


# -- worker-post payload builders: pure, so that the tests hold them
# against the JAX package's byte for byte ------------------------------------

def lease_renew_ops(identity: str, rank: int, epoch: int, renewals: int,
                    snap_json: bytes):
    """The metrics snapshot and the lease renewal that ride one batch each
    push period.  The lease VALUE changes every renewal (the driver judges
    freshness by the time the value last changed, on its own clock):
    ``renewals`` is that changing part."""
    lease = json.dumps({"rank": rank, "epoch": epoch,
                        "renewals": renewals}).encode()
    return [("set", METRICS_SCOPE, f"rank-{rank}", snap_json),
            ("set", LEASE_SCOPE, identity, lease)]


def reset_request_payload(epoch: int, reason: str) -> bytes:
    """An epoch-stamped reset request; the driver honours the CURRENT epoch
    only (an older one was answered by a later bump already)."""
    return json.dumps({"epoch": epoch, "reason": reason[:512]}).encode()


def demotion_report_payload(epoch: int, rank: int, hostname, ewma: float,
                            threshold: float, cycles: int,
                            posted_unix: float) -> bytes:
    """An epoch-stamped demotion report with the EWMA evidence, so that the
    driver's log and flight recorder say why the host was shed."""
    return json.dumps({
        "epoch": epoch,
        "rank": rank,
        "hostname": hostname,
        "ewma": round(ewma, 6),
        "threshold": threshold,
        "cycles": cycles,
        "posted_unix": posted_unix,
    }).encode()


_clients: Dict[Tuple[str, int], HTTPStoreClient] = {}
_clients_lock = threading.Lock()


def store_client() -> Optional[HTTPStoreClient]:
    """The rendezvous server's client from the environment (None outside
    launched jobs), one per address for the process."""
    addr = env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR)
    port = env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0)
    if not addr or not port:
        return None
    with _clients_lock:
        store = _clients.get((addr, port))
        if store is None:
            store = HTTPStoreClient(addr, port, env_mod.get_float(
                env_mod.HOROVOD_MESH_STARTUP_TIMEOUT,
                env_mod.DEFAULT_MESH_STARTUP_TIMEOUT))
            _clients[(addr, port)] = store
        return store


def request_reset(reason: str) -> bool:
    """Ask the elastic driver for a new membership epoch.

    After an abort that leaves every worker alive (a stall shutdown, a
    coordinated abort) the driver sees no exit and no host change, and
    nothing would publish the epoch that the survivors wait for.  The
    request makes such an abort recover in one discovery tick.
    Best-effort and epoch-stamped; returns whether it was posted."""
    try:
        store = store_client()
        if store is None:
            return False
        flight_recorder.record("reset_request", epoch=env_mod.get_epoch(),
                               reason=reason[:300])
        store.set(RESET_REQUEST_SCOPE, identity(),
                  reset_request_payload(env_mod.get_epoch(), reason))
        return True
    except Exception:  # noqa: BLE001 — the retry loop's slow path (re-init
        # timeout, transient exit, respawn) remains; failing here must not
        # mask the error being recovered from
        return False


def post_demotion_report(rank: int, ewma: float, threshold: float,
                         cycles: int) -> bool:
    """Post the coordinator's chronic-straggler verdict to the driver,
    epoch-stamped and best-effort.  Returns whether it was posted (False
    outside launched jobs: the verdict is then detector-only).  The report
    names no host: the driver resolves the rank from its own slot table,
    which is authoritative (the JAX client also lists the table's keys to
    name the host in the report's evidence)."""
    try:
        store = store_client()
        if store is None:
            return False
        store.set(DEMOTION_REPORT_SCOPE, identity(), demotion_report_payload(
            env_mod.get_epoch(), rank, None, ewma, threshold, cycles,
            time.time()))
        return True
    except Exception:  # noqa: BLE001 — a slow host is a degradation, not
        # an emergency
        return False


class _LeaseRenewals:
    """The lease and metrics push of ``horovod_tpu/core/state.py:423-510``:
    every period, this identity's lease (its value changes each time) and
    the process's metrics snapshot, in one store batch.  Best-effort: a
    failed push is counted and logged once per outage."""

    def __init__(self, store: HTTPStoreClient, period: float):
        self.store = store
        self.period = period
        self.renewals = 0
        self._failing = False
        self.thread = threading.Thread(target=self._loop,
                                       name="hvd-lease-renewals", daemon=True)

    def _push(self) -> None:
        from ..core.state import global_state

        self.renewals += 1
        topo = global_state().topo
        rank = topo.rank if topo is not None else \
            env_mod.get_int(env_mod.HOROVOD_RANK, 0)
        epoch = env_mod.get_epoch()
        snap = metrics.registry.snapshot()
        snap["rank"] = rank
        snap["epoch"] = epoch
        try:
            self.store.batch(lease_renew_ops(
                identity(), rank, epoch, self.renewals,
                json.dumps(snap).encode()))
        except Exception as e:  # noqa: BLE001 — a missed renewal must not
            # hurt the job
            metrics.inc("lease_renew_failures_total")
            if not self._failing:
                log.warning("lease renewal failed (%s); retrying every "
                            "%.1fs", e, self.period)
            self._failing = True
            return
        self._failing = False

    def _loop(self) -> None:
        while True:
            self._push()
            time.sleep(self.period)


_lease_renewals: Optional[_LeaseRenewals] = None


def start_lease_renewals() -> None:
    """Start this process's lease renewals once, for the rest of its life:
    the lease says that the process lives, across the runtime's resets and
    whatever the world's size.  The period is ``HOROVOD_METRICS_PUSH_SECS``
    (0 turns them off); outside launched jobs there is no driver to renew
    with."""
    global _lease_renewals
    period = env_mod.get_float(env_mod.HOROVOD_METRICS_PUSH_SECS,
                               env_mod.DEFAULT_METRICS_PUSH_SECS)
    if period <= 0 or _lease_renewals is not None:
        return
    store = store_client()
    if store is None:
        return
    _lease_renewals = _LeaseRenewals(store, period)
    _lease_renewals.thread.start()


def current_reshard_info(timeout: Optional[float] = None) -> Optional[dict]:
    """The reshard marker on this identity's slot entry at the CURRENT
    epoch, or None when that entry carries none (or outside launched jobs).
    Read from the store rather than kept from the refresh: a spawned joiner
    never passes through the refresh, yet must agree with the survivors on
    ``sync_root``.  Every rank of the epoch reads the same table, so no
    rank may decide on its own: a failed or missing read is retried with
    backoff until ``timeout`` (``HOROVOD_MESH_STARTUP_TIMEOUT``), and an
    entry of a newer epoch means this world is already gone; either ends
    in ``HorovodInternalError``, and ``run`` re-rendezvouses."""
    store = store_client()
    if store is None:
        return None
    if timeout is None:
        timeout = env_mod.get_float(env_mod.HOROVOD_MESH_STARTUP_TIMEOUT,
                                    env_mod.DEFAULT_MESH_STARTUP_TIMEOUT)
    my_epoch = env_mod.get_epoch()
    me = identity()
    deadline = time.monotonic() + timeout
    delay = 0.05
    while True:
        try:
            raw = store.get(RANK_AND_SIZE_SCOPE, me)
            seen = "no entry" if raw is None else None
        except Exception as e:  # noqa: BLE001 — retried below
            raw, seen = None, f"{type(e).__name__}: {e}"
            log.warning("reading the reshard marker of %s failed (%s); "
                        "retrying", me, seen)
        if raw is not None:
            slot = json.loads(bytes(raw).decode())
            epoch = slot.get("epoch", -1)
            if epoch == my_epoch:
                break
            if epoch > my_epoch:
                raise HorovodInternalError(
                    f"the slot table of {me} is at epoch {epoch}, past this "
                    f"world's {my_epoch}: re-rendezvous")
            seen = f"an entry of epoch {epoch}"
        if time.monotonic() > deadline:
            raise HorovodInternalError(
                f"no slot entry of {me} at epoch {my_epoch} within "
                f"{timeout:.0f}s (last read: {seen})")
        time.sleep(delay * (0.5 + 0.5 * random.random()))
        delay = min(delay * 2.0, 2.0)
    if not slot.get("reshard"):
        return None
    return {"epoch": slot["epoch"],
            "sync_root": int(slot.get("sync_root", 0)),
            "joiners": list(slot.get("joiners") or [])}


def refresh_topology_from_rendezvous(timeout: float = 120.0
                                     ) -> ProcessTopology:
    """Block until the driver publishes a slot table for a NEW epoch, ack
    it, and adopt this process's coordinates (``HOROVOD_RANK`` ...
    ``HOROVOD_EPOCH``); exit with 0 when this identity was removed."""
    store = store_client()
    if store is None:
        raise RuntimeError("elastic re-init requires a rendezvous server")
    my_epoch = env_mod.get_epoch()
    me = identity()
    # Exponential backoff with jitter, capped at 2 s: after a host failure
    # every survivor polls at once.
    deadline = time.monotonic() + timeout
    delay = 0.05
    last_err = None
    while True:
        try:
            raw = store.get(RANK_AND_SIZE_SCOPE, me)
        except Exception as e:  # noqa: BLE001
            last_err = e
            raw = None
        if raw is not None:
            slot = json.loads(bytes(raw).decode())
            if slot.get("epoch", 0) > my_epoch:
                break
        if time.monotonic() > deadline:
            detail = f" (last store error: {last_err})" if last_err else ""
            raise TimeoutError(
                f"no new rendezvous assignment within {timeout:.0f}s"
                f"{detail}")
        time.sleep(delay * (0.5 + 0.5 * random.random()))
        delay = min(delay * 2.0, 2.0)

    # The ack stops the driver's re-notification of this identity.
    store.set(EPOCH_ACK_SCOPE, me, str(slot["epoch"]).encode())
    if slot["rank"] < 0:
        sys.exit(0)  # this host left the job
    for key, var in [("rank", env_mod.HOROVOD_RANK),
                     ("size", env_mod.HOROVOD_SIZE),
                     ("local_rank", env_mod.HOROVOD_LOCAL_RANK),
                     ("local_size", env_mod.HOROVOD_LOCAL_SIZE),
                     ("cross_rank", env_mod.HOROVOD_CROSS_RANK),
                     ("cross_size", env_mod.HOROVOD_CROSS_SIZE)]:
        os.environ[var] = str(slot[key])
    os.environ[env_mod.HOROVOD_EPOCH] = str(slot["epoch"])
    flight_recorder.record("epoch_change", epoch=slot["epoch"],
                           rank=slot["rank"], size=slot["size"],
                           reshard=bool(slot.get("reshard")))
    return ProcessTopology(
        rank=slot["rank"], size=slot["size"],
        local_rank=slot["local_rank"], local_size=slot["local_size"],
        cross_rank=slot["cross_rank"], cross_size=slot["cross_size"],
        hostname=slot["hostname"])
