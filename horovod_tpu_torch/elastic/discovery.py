"""Host discovery + host-set management for elastic jobs.

The port's copy of ``horovod_tpu/elastic/discovery.py``.  Reference:
``runner/elastic/discovery.py:1-164`` — ``HostDiscoveryScript``
shells out to the user-provided script (one ``host[:slots]`` per line) and
``HostManager`` diffs successive host sets, maintains the blacklist, and
orders hosts stably so surviving hosts keep their relative rank order
across updates (``discovery.py:114-122``).
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import env as env_mod
from ..common.logging_util import get_logger
from ..runner.hosts import HostInfo

log = get_logger("horovod_tpu_torch.elastic.discovery")


class HostDiscovery:
    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        """{hostname: slots} of currently healthy hosts."""
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    def __init__(self, hosts: List[HostInfo]):
        self._hosts = {h.hostname: h.slots for h in hosts}

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return dict(self._hosts)


class HostDiscoveryScript(HostDiscovery):
    """Runs the user script; output = one ``host`` or ``host:slots`` per
    line (reference ``discovery.py:130-163``).  On a GPU fleet the script
    lists the hosts that are healthy and not preempted."""

    def __init__(self, script: str, default_slots: int = 1):
        self._script = script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.check_output(self._script, shell=True, text=True,
                                      timeout=30)
        hosts: Dict[str, int] = {}
        for part in out.splitlines():
            part = part.strip()
            if not part:
                continue
            info = HostInfo.from_string(
                part if ":" in part else f"{part}:{self._default_slots}")
            hosts[info.hostname] = info.slots
        return hosts


class HostManager:
    """Tracks the current host set, stable ordering, and the blacklist
    (reference ``discovery.py:79-121``).

    The blacklist supports a COOLDOWN (``HOROVOD_BLACKLIST_COOLDOWN_SECS``
    or the constructor arg; 0 = permanent, the reference behavior): on a
    preemptible fleet a host is usually "bad" only transiently —
    preempted, rebooting, migrating — and a permanent blacklist shrinks
    the pool monotonically until the job starves below min_np.  After the
    cooldown the host rejoins the candidate pool; if it fails again a
    FRESH strike restarts the clock.  Strikes are idempotent while
    active: re-blacklisting an already-listed host (repeated demotion
    reports within one epoch, a crash racing a demotion) keeps the
    original expiry, so strikes never stack into a de-facto permanent
    ban."""

    def __init__(self, discovery: HostDiscovery,
                 blacklist_cooldown: Optional[float] = None):
        self._discovery = discovery
        self._lock = threading.Lock()
        self._order: List[str] = []       # stable rank order
        self._slots: Dict[str, int] = {}
        # hostname -> expiry (monotonic seconds; inf = permanent)
        self._blacklist: Dict[str, float] = {}
        self._cooldown = env_mod.get_float(
            env_mod.HOROVOD_BLACKLIST_COOLDOWN_SECS, 0.0) \
            if blacklist_cooldown is None else blacklist_cooldown

    @staticmethod
    def _now() -> float:
        return time.monotonic()

    def blacklist(self, hostname: str,
                  evidence: Optional[str] = None) -> bool:
        """Blacklist ``hostname``; True on a NEW strike, False when the
        host was already listed (the existing expiry is kept — see the
        class docstring).  ``evidence`` (e.g. the straggler EWMA behind a
        demotion) is logged with the strike so the driver log and the
        flight recorder agree on *why* the host was shed."""
        expiry = self._now() + self._cooldown \
            if self._cooldown > 0 else float("inf")
        with self._lock:
            self._expire_blacklist_locked()
            if hostname in self._blacklist:
                log.debug("host %s already blacklisted; strike not stacked",
                          hostname)
                return False
            log.warning(
                "blacklisting host %s%s%s", hostname,
                f" for {self._cooldown:g}s" if self._cooldown > 0
                else " permanently",
                f" (evidence: {evidence})" if evidence else "")
            self._blacklist[hostname] = expiry
            return True

    def _expire_blacklist_locked(self) -> None:
        now = self._now()
        for host in [h for h, exp in self._blacklist.items() if exp <= now]:
            log.warning("blacklist cooldown expired for host %s; it may "
                        "rejoin the pool", host)
            del self._blacklist[host]

    def is_blacklisted(self, hostname: str) -> bool:
        with self._lock:
            self._expire_blacklist_locked()
            return hostname in self._blacklist

    @property
    def current_hosts(self) -> List[HostInfo]:
        with self._lock:
            return [HostInfo(h, self._slots[h]) for h in self._order]

    def update_available_hosts(self) -> Tuple[bool, bool]:
        """Polls discovery; returns (changed, removal_or_failure).

        Ordering rule: surviving hosts keep their existing positions, new
        hosts append — rank assignments stay stable across growth."""
        found = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            self._expire_blacklist_locked()
            found = {h: s for h, s in found.items()
                     if h not in self._blacklist}
            removed = [h for h in self._order if h not in found]
            added = [h for h in found if h not in self._slots]
            slots_changed = any(
                h in self._slots and self._slots[h] != s
                for h, s in found.items())
            changed = bool(removed or added or slots_changed)
            new_order = [h for h in self._order if h in found]
            new_order.extend(h for h in found if h not in new_order)
            self._order = new_order
            self._slots = found
            return changed, bool(removed or slots_changed)

    def total_slots(self) -> int:
        with self._lock:
            return sum(self._slots.values())
