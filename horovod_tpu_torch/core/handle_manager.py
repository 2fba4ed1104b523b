"""Handle bookkeeping for async collectives.

Counterpart of ``horovod_tpu/core/handle_manager.py`` (the reference's
``horovod/torch/handle_manager.cc`` plus the poll/synchronize contract of
``mpi_ops_v2.cc:323-331``); waiters sleep on events instead of spinning."""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

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

    def wait_many(self, handles: Sequence[int],
                  timeout: Optional[float] = None) -> List[Any]:
        """Wait for a batch of handles; their results in handle order
        (``horovod_tpu/core/handle_manager.py::wait_many``).  ``timeout``
        bounds the whole batch (one deadline).  On an error status or a
        timeout every handle of the batch is released before this raises,
        so a step that failed part-way leaks no event."""
        events = []
        with self._lock:
            for h in handles:
                event = self._events.get(h)
                if event is None:
                    raise ValueError(f"unknown handle {h}")
                events.append(event)
        deadline = None if timeout is None else time.monotonic() + timeout
        timed_out = None
        for h, event in zip(handles, events):
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not event.wait(left):
                timed_out = h
                break
        results, first_error = [], None
        with self._lock:
            for h in handles:
                done = self._done.pop(h, None)
                self._events.pop(h, None)
                if done is None:        # timed out before completion
                    results.append(None)
                    continue
                status, result = done
                if not status.ok and first_error is None:
                    first_error = status.error_message
                results.append(result)
        if timed_out is not None:
            raise TimeoutError(
                f"collective batch timed out after {timeout}s waiting on "
                f"handle {timed_out}")
        if first_error is not None:
            raise HorovodInternalError(first_error)
        return results
