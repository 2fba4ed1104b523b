"""Worker-side elastic state and the ``@hvd.elastic.run`` wrapper.

The port's copy of ``horovod_tpu/elastic/state.py`` (reference
``common/elastic.py:1-168``), without its JAX state and XLA plane.  The
contract:

- ``state.commit()`` saves a snapshot and raises ``HostsUpdatedInterrupt``
  when the driver has reported a change of the host set;
- ``HorovodInternalError`` (a collective failed: a peer died or left)
  rolls back to the last commit, re-rendezvouses and retries;
- ``HostsUpdatedInterrupt`` keeps the state, re-rendezvouses and retries;
- after every reset the state is synced from one rank so that new and
  restored workers agree, unless the epoch's reshard marker says that no
  process joined (``_sync_for_epoch``).

Two things differ from the JAX code, on purpose:

- **The sync after a growth.**  ``HostsUpdatedInterrupt.skip_sync`` is
  true only when every change since the worker last looked was a
  removal, as in reference Horovod (``HostsUpdatedInterrupt(all_update ==
  HostUpdateResult.removed)``, ``horovod/common/elastic.py``), and no rank
  decides on its own to skip the sync: the marker, which every rank reads
  from the store at the current epoch, decides for all of them, and
  without it every rank syncs from rank 0.  The JAX package skips the sync
  on its own after an addition, while the process that joined waits in
  the sync's broadcast: both hang.
- **Re-init.**  The runtime comes back on the device that the first
  ``hvd.init()`` was given (``basics.init_device``), so that two ranks that
  share one card keep sharing it.
"""

from __future__ import annotations

import copy
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from ..common.logging_util import get_logger
from ..core import flight_recorder

log = get_logger("horovod_tpu_torch.elastic.run")

_host_update_lock = threading.Lock()
_host_update_event = threading.Event()
# Whether every update since the last consume was a removal.
_host_update_skip_sync = [True]
# The highest epoch a ping named (inf for a ping without one).
_host_update_epoch = [-1.0]

#: One record per reset of this process, in order: what ended the attempt
#: (``cause``), the epoch it re-rendezvoused into, and the wall-clock time
#: (``time.time()``, comparable across the job's processes on one host) at
#: which each part ended: ``caught`` (the exception reached ``run``),
#: ``torn_down``, ``adopted`` (the new epoch's coordinates),
#: ``initialized`` (the runtime and its groups built), ``synced``.
reset_log: List[Dict[str, Any]] = []


def notify_hosts_updated(added_only: bool = False,
                         epoch: Optional[int] = None) -> None:
    """The notify service's entry: the driver reports a change of the host
    set, which surfaces at the next ``commit()`` / ``check_host_updates()``.

    ``added_only`` says the change only added hosts.  Staleness is judged
    when the update is consumed, not here: a ping can arrive before this
    worker re-rendezvouses into the very epoch it names."""
    with _host_update_lock:
        _host_update_skip_sync[0] = _host_update_skip_sync[0] and \
            not added_only
        _host_update_epoch[0] = max(
            _host_update_epoch[0], float("inf") if epoch is None else epoch)
        _host_update_event.set()


def _consume_host_update() -> Optional[bool]:
    """None when no update is pending or it is stale (its epoch is not
    newer than this worker's); else whether the sync may be skipped."""
    with _host_update_lock:
        if not _host_update_event.is_set():
            return None
        _host_update_event.clear()
        skip = _host_update_skip_sync[0]
        _host_update_skip_sync[0] = True
        epoch = _host_update_epoch[0]
        _host_update_epoch[0] = -1.0
    if epoch <= env_mod.get_epoch():
        return None
    return skip


class State:
    """Base elastic state (reference ``common/elastic.py:24-100``)."""

    def __init__(self, **kwargs):
        self._reset_callbacks: List[Callable[[], None]] = []

    def register_reset_callbacks(self,
                                 callbacks: List[Callable[[], None]]) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def commit(self) -> None:
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        skip = _consume_host_update()
        if skip is not None:
            raise HostsUpdatedInterrupt(skip_sync=skip)

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self, root_rank: int = 0) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """Picklable attributes, synced by a broadcast from the root (reference
    ``common/elastic.py:103-144``)."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._known = list(kwargs.keys())
        self.save()

    def save(self) -> None:
        self._saved = {k: copy.deepcopy(getattr(self, k)) for k in self._known}

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self, root_rank: int = 0) -> None:
        from ..functions import broadcast_object

        values = {k: getattr(self, k) for k in self._known}
        synced = broadcast_object(values, root_rank=root_rank,
                                  name="elastic.objstate")
        # The root's attribute set, not only its values: a joiner whose
        # defaults differ must track what the root tracks.
        self._known = list(synced.keys())
        for k, v in synced.items():
            setattr(self, k, v)
        self.save()


def _reset_and_reinit() -> None:
    """Tear the runtime down, take the new epoch's coordinates from the
    rendezvous and bring the runtime up again on the device the first
    ``hvd.init()`` was given (reference ``gloo_context.cc:154-189``)."""
    from .. import basics
    from ..core import state as core_state
    from .rendezvous_client import refresh_topology_from_rendezvous

    basics._internal_reset()
    _mark("torn_down")
    topo = refresh_topology_from_rendezvous()
    _mark("adopted", epoch=env_mod.get_epoch())
    core_state.global_state().initialize(basics.init_device(), topology=topo)
    _mark("initialized")


def _mark(part: str, **fields) -> None:
    """Stamp the end of one part of the current reset (:data:`reset_log`)."""
    if reset_log:
        reset_log[-1][part] = time.time()
        reset_log[-1].update(fields)


def _request_epoch_reset(err: BaseException) -> None:
    """Ask the driver for a new epoch after any ``HorovodInternalError``
    (elastic jobs only): an abort that leaves every worker alive shows the
    driver no exit to act on.  When the error was a death, the request
    may cost one extra epoch; the driver filters stale requests."""
    if not env_mod.get_bool(env_mod.HOROVOD_ELASTIC):
        return
    from .rendezvous_client import request_reset

    request_reset(f"{type(err).__name__}: {err}")


def _sync_for_epoch(state: State) -> None:
    """The sync after a (re-)init.  Under a reshard-marked epoch the marker
    decides, the same on every rank: nothing when no process joined (every
    participant is a survivor restored to the same commit), else from
    ``sync_root``, the lowest rank among the seasoned survivors (rank 0
    may be the fresh process).  The marker is read per identity at the
    current epoch (``current_reshard_info`` retries a failed read, or
    raises ``HorovodInternalError``), so joiners and survivors pick the
    same root.  Without a marker every rank syncs from rank 0."""
    info = None
    if env_mod.get_bool(env_mod.HOROVOD_ELASTIC) and \
            env_mod.get_bool(env_mod.HOROVOD_RESHARD, True):
        from .rendezvous_client import current_reshard_info

        info = current_reshard_info()
    if info is None:
        state.sync()
        return
    if not info["joiners"]:
        flight_recorder.record("reshard_sync_skipped", epoch=info["epoch"])
        return
    flight_recorder.record("reshard_sync", epoch=info["epoch"],
                           root=info["sync_root"],
                           joiners=len(info["joiners"]))
    state.sync(root_rank=info["sync_root"])


def _teardown() -> None:
    """Tear the runtime down between retries; never raises."""
    try:
        from .. import basics

        basics._internal_reset()
    except Exception:  # noqa: BLE001
        log.warning("elastic teardown failed", exc_info=True)


def run(func: Callable) -> Callable:
    """Decorator: retry ``func(state, ...)`` across membership changes
    (reference ``run_fn``, ``common/elastic.py:147-168``).  A failed re-init
    is retried; after ``WORKER_REINIT_ATTEMPTS`` in a row the worker exits
    with ``TRANSIENT_EXIT_CODE``, so that the driver respawns it instead of
    blacklisting its host."""

    def wrapper(state: State, *args, **kwargs):
        from .. import basics
        from .constants import TRANSIENT_EXIT_CODE, WORKER_REINIT_ATTEMPTS

        notification_manager.start()
        reset_limit = notification_manager.reset_limit
        resets = 0
        reinit_failures = 0
        pending_reset = False
        while True:
            if not basics.is_initialized():
                try:
                    _reset_and_reinit()
                except (SystemExit, KeyboardInterrupt):
                    raise  # removed from the job, or the user's interrupt
                except BaseException as e:  # noqa: BLE001
                    reinit_failures += 1
                    log.warning("elastic re-init failed (%d/%d): %s",
                                reinit_failures, WORKER_REINIT_ATTEMPTS, e)
                    if reinit_failures >= WORKER_REINIT_ATTEMPTS:
                        log.error("giving up after %d re-init failures; "
                                  "exiting for a driver respawn",
                                  reinit_failures)
                        sys.exit(TRANSIENT_EXIT_CODE)
                    _teardown()
                    continue
                reinit_failures = 0
            if pending_reset:
                # After the re-init (reference order: reset, then
                # on_reset): the handlers see the new rank and size.
                state.on_reset()
                pending_reset = False
            try:
                _sync_for_epoch(state)
                _mark("synced")
                return func(state, *args, **kwargs)
            except HorovodInternalError as e:
                reset_log.append({"cause": type(e).__name__,
                               "caught": time.time()})
                state.restore()
                _request_epoch_reset(e)
            except HostsUpdatedInterrupt as e:
                reset_log.append({"cause": type(e).__name__,
                               "caught": time.time()})
            resets += 1
            if reset_limit is not None and resets >= reset_limit:
                raise RuntimeError(
                    f"Exceeded elastic reset limit ({reset_limit})")
            pending_reset = True
            _teardown()

    return wrapper


class _NotificationManager:
    """Once per process, in elastic jobs: starts the worker's notify server
    (reference ``elastic/worker.py``) and the lease renewals, and routes
    the coordinator's demotion verdicts to the driver."""

    def __init__(self):
        self._started = False
        self.reset_limit: Optional[int] = None

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        if not env_mod.get_bool(env_mod.HOROVOD_ELASTIC):
            return
        from ..core import controller
        from .rendezvous_client import (
            post_demotion_report,
            start_lease_renewals,
        )
        from .worker import start_notification_service

        start_notification_service()
        start_lease_renewals()
        controller.demotion_reporter = post_demotion_report
        limit = env_mod.get_int(env_mod.HOROVOD_ELASTIC_RESET_LIMIT, 0)
        self.reset_limit = limit if limit > 0 else None


notification_manager = _NotificationManager()
