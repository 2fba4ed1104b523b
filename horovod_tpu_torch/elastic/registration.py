"""Worker lifecycle registry.

The port's copy of ``horovod_tpu/elastic/registration.py``.  Reference:
``runner/elastic/registration.py:1-173`` — ``WorkerStateRegistry``
counts READY / SUCCESS / FAILURE per slot for the current rendezvous epoch
and decides when to trigger a new rendezvous (all slots accounted for) or
finish the job (success quorum / total failure), bounded by
``--reset-limit``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, world_size: int):
        self._lock = threading.Lock()
        self._barrier = threading.Event()
        self.reset(world_size)

    def reset(self, world_size: int) -> None:
        with self._lock:
            self._world_size = world_size
            self._states: Dict[int, str] = {}
            self._barrier.clear()

    def record(self, rank: int, state: str) -> None:
        with self._lock:
            self._states[rank] = state
            if len(self._states) >= self._world_size:
                self._barrier.set()

    def record_ready(self, rank: int) -> None:
        self.record(rank, READY)

    def record_success(self, rank: int) -> None:
        self.record(rank, SUCCESS)

    def record_failure(self, rank: int) -> None:
        self.record(rank, FAILURE)

    def count(self, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == state)

    def failed_ranks(self) -> Set[int]:
        with self._lock:
            return {r for r, s in self._states.items() if s == FAILURE}

    def all_accounted(self) -> bool:
        return self._barrier.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every slot reported a terminal/ready state."""
        return self._barrier.wait(timeout)
