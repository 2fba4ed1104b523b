"""Handle bookkeeping for async collectives.

Counterpart of ``horovod_tpu/core/handle_manager.py`` (the reference's
``horovod/torch/handle_manager.cc`` plus the poll/synchronize contract of
``mpi_ops_v2.cc:323-331``); waiters sleep on events instead of spinning."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from ..common.exceptions import HorovodInternalError
from .tensor_queue import Status


class HandleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._done: Dict[int, Tuple[Status, Any]] = {}
        self._events: Dict[int, threading.Event] = {}

    def allocate(self) -> int:
        with self._lock:
            handle = self._next
            self._next += 1
            self._events[handle] = threading.Event()
            return handle

    def mark_done(self, handle: int, status: Status, result: Any = None) -> None:
        with self._lock:
            event = self._events.get(handle)
            if event is None:
                # Discarded handle (failed enqueue): nobody will wait on it.
                return
            self._done[handle] = (status, result)
        event.set()

    def discard(self, handle: int) -> None:
        """Release a handle nobody will wait on (failed enqueue)."""
        with self._lock:
            self._events.pop(handle, None)
            self._done.pop(handle, None)

    def poll(self, handle: int) -> bool:
        with self._lock:
            return handle in self._done

    def wait(self, handle: int, timeout: Optional[float] = None) -> Any:
        """Block until done; raises on error status. Releases the handle."""
        with self._lock:
            event = self._events.get(handle)
        if event is None:
            raise ValueError(f"unknown handle {handle}")
        if not event.wait(timeout):
            raise TimeoutError(f"collective (handle {handle}) timed out")
        with self._lock:
            status, result = self._done.pop(handle)
            self._events.pop(handle, None)
        if not status.ok:
            raise HorovodInternalError(status.error_message)
        return result
