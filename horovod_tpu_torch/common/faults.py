"""Deterministic fault injection at named sites.

The port's copy of ``horovod_tpu/common/faults.py``: the same grammar, the
same per-clause counters and the same actions, so that a
``HOROVOD_FAULT_SPEC`` that the JAX runtime acts on fires at the same call
here, or is refused when it names a site whose layer the port lacks.

Spec grammar (``HOROVOD_FAULT_SPEC``, clauses joined by ``;``)::

    clause  := site[:key=value]...
    site    := controller.negotiate | controller.tally |
               enqueue.collective | dispatch.collective |
               worker.spawn | ckpt.save | store.put | rendezvous.get |
               store.get_serve | driver.tick
               (tcp.send, tcp.recv, shm.send and shm.recv parse in the JAX
               package only; here they raise ValueError naming the item of
               ROADMAP.md that brings their layer)
    keys    := rank=N       only fire on this Horovod rank
               peer=N       only fire when the op targets this peer rank
               nth=N        fire exactly on the N-th matching call (1-based)
               after=N      fire on every matching call after the first N
               action=NAME[,ARG]

    actions := hang            block forever (a stuck syscall)
               delay_ms,MS     sleep MS milliseconds, then proceed
               raise           raise FaultInjectedError (HorovodInternalError)
               raise_oserror   raise OSError(ECONNRESET): a torn connection
               exit[,CODE]     os._exit(CODE or 1): a hard process death
               drop, corrupt[,N], truncate[,N]
                               payload actions, valid on the transport send
                               sites only, so refused here as the JAX parser
                               refuses them on every other site

Where each site sits:

- ``enqueue.collective``: ``core/tensor_queue.py``, ``TensorQueue.add``,
  before the lock (a delay makes this rank a compute straggler);
- ``dispatch.collective``: ``core/state.py``, the dispatch of each agreed
  response;
- ``controller.negotiate``: ``core/controller.py``, each cycle's round;
- ``controller.tally``: rank 0's tally of a request at size > 1, through
  :func:`inject_deferred`: a ``delay_ms`` parks the tally and the
  controller replays it once the delay has passed, so that the lag lands
  on the matched rank while the cycles keep turning;
- ``worker.spawn``: ``runner/launch.py``, each worker's spawn, matched on
  the slot's rank;
- ``ckpt.save``: ``checkpoint.py``, between the payload's publish and its
  manifest;
- ``store.put``: ``transport/store.py``, each ``set`` and each ``batch``
  of the rendezvous store's clients;
- ``rendezvous.get``: ``transport/store.py``, each ``get`` of a client;
- ``store.get_serve``: ``runner/rendezvous.py``, each ``GET`` the
  rendezvous server serves (``exit`` on the supervised server is a kill
  in mid-serve);
- ``driver.tick``: ``elastic/driver.py``, each tick of the elastic
  driver's discovery loop, outside its timing (``raise`` kills the loop,
  ``exit`` the launcher).

Every clause keeps its own count of matching calls, so a spec against a
deterministic call sequence fails at the same point in every run.  When no
spec is set ``ACTIVE`` is False, and every site guards with
``if faults.ACTIVE:``: one attribute read.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from typing import List, Optional

from .env import HOROVOD_FAULT_SPEC, HOROVOD_RANK
from .exceptions import FaultInjectedError

SITES = (
    "tcp.send",
    "tcp.recv",
    "shm.send",
    "shm.recv",
    "controller.negotiate",
    "controller.tally",
    "enqueue.collective",
    "dispatch.collective",
    "rendezvous.get",
    "worker.spawn",
    "ckpt.save",
    "store.put",
    "store.get_serve",
    "driver.tick",
)

#: The sites of the JAX package whose layer the port does not have yet, with
#: the slice of ROADMAP.md that brings it.  A clause on one of them would
#: match no call: it is refused when the spec is parsed.
MISSING_SITES = {
    "tcp.send": "ROADMAP A9 (the cross-host transport)",
    "tcp.recv": "ROADMAP A9 (the cross-host transport)",
    "shm.send": "ROADMAP A9 (the cross-host transport)",
    "shm.recv": "ROADMAP A9 (the cross-host transport)",
}

_ACTIONS = ("hang", "delay_ms", "raise", "raise_oserror", "exit", "drop",
            "corrupt", "truncate")

#: Actions that rewrite an operation's payload; only a transport send
#: carries one.
_PAYLOAD_ACTIONS = ("drop", "corrupt", "truncate")

_SEND_SITES = ("tcp.send", "shm.send")

#: False when no spec is configured: the sites then never call ``inject``.
ACTIVE = False

_lock = threading.Lock()
_clauses: List["_Clause"] = []


class _Clause:
    __slots__ = ("site", "rank", "peer", "nth", "after", "action",
                 "action_arg", "calls", "fired")

    def __init__(self, site: str, rank: Optional[int], peer: Optional[int],
                 nth: Optional[int], after: Optional[int],
                 action: str, action_arg: Optional[str]):
        self.site = site
        self.rank = rank
        self.peer = peer
        self.nth = nth
        self.after = after
        self.action = action
        self.action_arg = action_arg
        self.calls = 0       # matching calls seen so far
        self.fired = False   # nth clauses fire once

    def matches(self, site: str, rank: Optional[int],
                peer: Optional[int]) -> bool:
        if site != self.site:
            return False
        if self.rank is not None and rank != self.rank:
            return False
        if self.peer is not None and peer != self.peer:
            return False
        return True

    def should_fire(self) -> bool:
        """Count a matching call; True when the action fires on it."""
        self.calls += 1
        if self.nth is not None:
            if self.fired or self.calls != self.nth:
                return False
            self.fired = True
            return True
        if self.after is not None:
            return self.calls > self.after
        return True


def _parse_clause(text: str) -> _Clause:
    """One clause, checked as the JAX parser checks it; then a site whose
    layer the port lacks is refused."""
    parts = [p for p in text.strip().split(":") if p]
    if not parts:
        raise ValueError(f"empty fault clause in spec: {text!r}")
    site = parts[0].strip()
    if site not in SITES:
        raise ValueError(
            f"unknown fault site {site!r}; known sites: {', '.join(SITES)}")
    rank = peer = nth = after = None
    action = "raise"
    action_arg: Optional[str] = None
    for field in parts[1:]:
        if "=" not in field:
            raise ValueError(
                f"fault clause field {field!r} is not key=value "
                f"(clause: {text!r})")
        key, val = field.split("=", 1)
        key = key.strip()
        val = val.strip()
        if key == "rank":
            rank = int(val)
        elif key == "peer":
            peer = int(val)
        elif key == "nth":
            nth = int(val)
            if nth < 1:
                raise ValueError(f"nth must be >= 1 (clause: {text!r})")
        elif key == "after":
            after = int(val)
        elif key == "action":
            action, _, arg = val.partition(",")
            action = action.strip()
            action_arg = arg.strip() or None
            if action not in _ACTIONS:
                raise ValueError(
                    f"unknown fault action {action!r}; known actions: "
                    f"{', '.join(_ACTIONS)}")
        else:
            raise ValueError(
                f"unknown fault clause key {key!r} (clause: {text!r})")
    if nth is not None and after is not None:
        raise ValueError(f"nth and after are exclusive (clause: {text!r})")
    if action in _PAYLOAD_ACTIONS and site not in _SEND_SITES:
        # Every other site would ignore the action: a spec that injects
        # nothing must fail loudly.
        raise ValueError(
            f"action={action} is only valid for sites "
            f"{'/'.join(_SEND_SITES)} (clause: {text!r})")
    if site in MISSING_SITES:
        raise ValueError(
            f"fault site {site!r} needs {MISSING_SITES[site]}, which this "
            f"port does not have yet: the clause would inject nothing "
            f"(clause: {text!r})")
    return _Clause(site, rank, peer, nth, after, action, action_arg)


def configure(spec: Optional[str]) -> None:
    """(Re)parse a spec; ``None`` or empty turns injection off.  A grammar
    error raises ``ValueError``."""
    global ACTIVE
    with _lock:
        _clauses.clear()
        if spec:
            for raw in spec.split(";"):
                if raw.strip():
                    _clauses.append(_parse_clause(raw))
        ACTIVE = bool(_clauses)


def reset() -> None:
    """Turn injection off and forget every counter."""
    configure(None)


def _default_rank() -> int:
    try:
        return int(os.environ.get(HOROVOD_RANK, "-1") or "-1")
    except ValueError:
        return -1


def _matching(site: str, rank: Optional[int],
              peer: Optional[int]) -> List[_Clause]:
    with _lock:
        return [c for c in _clauses
                if c.matches(site, rank, peer) and c.should_fire()]


def inject(site: str, rank: Optional[int] = None,
           peer: Optional[int] = None) -> bool:
    """Fire every matching clause for this call.  Returns False (no site of
    the port carries a payload to drop or rewrite); the raising, hanging and
    exiting actions never return.  ``rank`` defaults to ``HOROVOD_RANK``."""
    if rank is None:
        rank = _default_rank()
    for clause in _matching(site, rank, peer):
        _record_fire(clause, site, rank)
        _run_action(clause, site, rank)
    return False


def inject_deferred(site: str, rank: Optional[int] = None) -> float:
    """Like :func:`inject`, but a ``delay_ms`` clause returns its delay in
    seconds instead of sleeping: the caller defers the work by that much
    (the controller parks the tally).  Other actions run as usual.  Returns
    0.0 when no delay fired."""
    if rank is None:
        rank = _default_rank()
    delay = 0.0
    for clause in _matching(site, rank, None):
        _record_fire(clause, site, rank)
        if clause.action == "delay_ms":
            delay = max(delay, float(clause.action_arg or "100") / 1000.0)
        else:
            _run_action(clause, site, rank)
    return delay


def _record_fire(clause: _Clause, site: str, rank: int) -> None:
    """Count the fire and put it in the flight recorder before the action
    runs: ``exit`` and ``hang`` never return, and a dump that cannot name
    the injected fault is of no use.  Imported here: ``core`` imports this
    module."""
    try:
        from ..core import flight_recorder, metrics

        metrics.inc("faults_injected_total")
        flight_recorder.record("fault", site=site, rank=rank,
                               action=clause.action, call=clause.calls)
    except Exception:  # noqa: BLE001 — never change the injected failure
        pass


def _run_action(clause: _Clause, site: str, rank: int) -> None:
    action = clause.action
    where = f"{site} (rank {rank}, call {clause.calls})"
    if action == "hang":
        while True:
            time.sleep(60.0)
    if action == "delay_ms":
        time.sleep(float(clause.action_arg or "100") / 1000.0)
        return
    if action == "raise":
        raise FaultInjectedError(f"injected fault at {where}")
    if action == "raise_oserror":
        raise OSError(errno.ECONNRESET,
                      f"injected connection reset at {where}")
    if action == "exit":
        os._exit(int(clause.action_arg or "1"))
    raise AssertionError(f"unreachable action {action!r}")


# Workers inherit HOROVOD_FAULT_SPEC from the launcher's environment and
# configure themselves when the package is imported.
configure(os.environ.get(HOROVOD_FAULT_SPEC))
