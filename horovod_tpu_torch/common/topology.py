"""Process topology: rank / size / local / cross coordinates.

Copy of ``horovod_tpu/common/topology.py``: a launcher exports each worker's
slot (rank, local_rank, cross_rank ...) as ``HOROVOD_*`` variables, the
reference's Gloo path (``gloo_context.cc:139-144``); without them the
process is rank 0 of 1.
"""

from __future__ import annotations

import dataclasses
import socket

from . import env


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    hostname: str = ""

    def __post_init__(self):
        if not (0 <= self.rank < self.size):
            raise ValueError(f"rank {self.rank} out of range for size {self.size}")
        if not (0 <= self.local_rank < self.local_size):
            raise ValueError(
                f"local_rank {self.local_rank} out of range for local_size {self.local_size}")
        if not (0 <= self.cross_rank < self.cross_size):
            raise ValueError(
                f"cross_rank {self.cross_rank} out of range for cross_size {self.cross_size}")
        if self.local_size * self.cross_size < self.size:
            raise ValueError(
                f"local_size {self.local_size} * cross_size {self.cross_size} "
                f"cannot cover size {self.size}")

    @property
    def is_homogeneous(self) -> bool:
        """True when every host has the same number of slots."""
        return self.local_size * self.cross_size == self.size


def from_env() -> ProcessTopology:
    """Build topology from launcher-provided env, defaulting to 1 process."""
    size = env.get_int(env.HOROVOD_SIZE, 1)
    return ProcessTopology(
        rank=env.get_int(env.HOROVOD_RANK, 0),
        size=size,
        local_rank=env.get_int(env.HOROVOD_LOCAL_RANK,
                               env.get_int(env.HOROVOD_RANK, 0)),
        local_size=env.get_int(env.HOROVOD_LOCAL_SIZE, size),
        cross_rank=env.get_int(env.HOROVOD_CROSS_RANK, 0),
        cross_size=env.get_int(env.HOROVOD_CROSS_SIZE, 1),
        hostname=env.get_str(env.HOROVOD_HOSTNAME, socket.gethostname()),
    )
