"""Host/slot parsing and rank assignment.

Copy of ``horovod_tpu/runner/hosts.py`` (the reference's
``runner/common/util/hosts.py``): ``parse_hosts`` turns ``"h1:4,h2:4"``
into :class:`HostInfo`, ``parse_host_files`` reads a ``--hostfile`` into
such a string, and :func:`get_host_assignments` gives one :class:`SlotInfo`
per process with its rank, local and cross coordinates, host-major.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..common import env


@dataclasses.dataclass(frozen=True)
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(spec: str) -> "HostInfo":
        spec = spec.strip()
        if ":" in spec:
            host, slots = spec.rsplit(":", 1)
            return HostInfo(host, int(slots))
        return HostInfo(spec, 1)


@dataclasses.dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_env(self) -> Dict[str, str]:
        return {
            env.HOROVOD_HOSTNAME: self.hostname,
            env.HOROVOD_RANK: str(self.rank),
            env.HOROVOD_SIZE: str(self.size),
            env.HOROVOD_LOCAL_RANK: str(self.local_rank),
            env.HOROVOD_LOCAL_SIZE: str(self.local_size),
            env.HOROVOD_CROSS_RANK: str(self.cross_rank),
            env.HOROVOD_CROSS_SIZE: str(self.cross_size),
        }


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """``"h1:4,h2:2"`` → ``[HostInfo(h1, 4), HostInfo(h2, 2)]``."""
    return [HostInfo.from_string(part)
            for part in hosts_string.split(",") if part.strip()]


def parse_host_files(filename: str) -> str:
    """``--hostfile`` format: one ``host slots=N`` (or ``host:N``) per line,
    ``#`` comments; returns the ``-H`` string (reference
    ``runner/launch.py`` hostfile handling)."""
    specs = []
    with open(filename) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                host, _, slots = line.partition("slots=")
                specs.append(f"{host.strip()}:{slots.strip()}")
            else:
                specs.append(line.replace(" ", ":"))
    return ",".join(specs)


def get_host_assignments(hosts: List[HostInfo], min_np: int,
                         max_np: Optional[int] = None) -> List[SlotInfo]:
    """Ranks host-major (all of host 0's slots, then host 1's ...),
    ``local_rank`` within the host, ``cross_rank`` the host's index among
    the hosts that have a process with that ``local_rank``.  Raises when
    fewer than ``min_np`` slots exist; caps at ``max_np``."""
    total = sum(h.slots for h in hosts)
    if total < min_np:
        raise ValueError(
            f"requested {min_np} processes but hosts only provide {total} "
            f"slots: {[f'{h.hostname}:{h.slots}' for h in hosts]}")
    np_ = min(total, max_np) if max_np else min_np
    used: List[Tuple[str, int]] = []
    remaining = np_
    for h in hosts:
        if remaining <= 0:
            break
        take = min(h.slots, remaining)
        used.append((h.hostname, take))
        remaining -= take
    slots: List[SlotInfo] = []
    rank = 0
    for hostname, count in used:
        for local_rank in range(count):
            peers = [h for h, c in used if c > local_rank]
            slots.append(SlotInfo(
                hostname=hostname, rank=rank, local_rank=local_rank,
                cross_rank=peers.index(hostname), size=np_,
                local_size=count, cross_size=len(peers)))
            rank += 1
    return slots
