"""TensorQueue — the hand-off point between framework threads and the
background thread.

Counterpart of ``horovod_tpu/core/tensor_queue.py`` (the reference's
``horovod/common/tensor_queue.h:32-58``): a lock-guarded table of in-flight
entries plus the queue of pending Requests.  Framework threads add
(entry, request) pairs; the background thread pops the requests each cycle
and later claims the entries a Response names.  Duplicate in-flight names
are an error (``DUPLICATE_NAME_ERROR``, ``common.h:164-167``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..common import faults
from ..common.exceptions import DuplicateNameError, HorovodInternalError
from . import timeline as timeline_mod
from .messages import Request, RequestType, Response


@dataclass
class Status:
    ok: bool = True
    error_message: str = ""
    # True when the op queued device work: the finalizer fires the callbacks
    # once the work's CUDA event completes (reference IN_PROGRESS +
    # finalizer-thread design, ``gpu_operations.h:98-127``).
    pending: bool = False

    @staticmethod
    def OK() -> "Status":
        return Status(True, "")

    @staticmethod
    def in_progress() -> "Status":
        return Status(True, "", pending=True)

    @staticmethod
    def error(msg: str) -> "Status":
        return Status(False, msg)


@dataclass
class TensorTableEntry:
    """Reference ``TensorTableEntry`` (``common.h:238-261``)."""

    tensor_name: str
    tensor: Optional[torch.Tensor] = None
    # Where the op writes the result: the input itself for the in-place
    # flavors, else allocated by the op.
    output: Optional[torch.Tensor] = None
    device: int = -1
    request_type: RequestType = RequestType.ALLREDUCE
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    root_rank: int = -1  # broadcast
    # Alltoall: the rows sent to, and received from, each rank.
    splits: Optional[List[int]] = None
    received_splits: Optional[List[int]] = None
    # CUDA tensors: an event recorded on the enqueuing caller's stream (the
    # reference's ready event), that stream, and the event the op records
    # when its work is queued (the finalizer waits on it).
    ready_event: Any = None
    ready_stream: Any = None
    done_event: Any = None
    # Called exactly once with (status, entry); entry.output holds the result.
    callback: Callable = field(default=lambda status, entry: None)


class TensorQueue:
    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, TensorTableEntry] = {}
        self._pending: List[Request] = []
        self._closed = False
        # The background loop parks on this event between idle cycles, so
        # an enqueue starts the next negotiation at once.
        self._wake: Optional[threading.Event] = None

    def set_wake_event(self, event: threading.Event) -> None:
        self._wake = event

    def _check_open(self) -> None:
        if self._closed:
            # The background loop has exited and drained the table; an add
            # after that point would strand its waiter forever.
            raise HorovodInternalError(
                "Horovod background loop is not running (shut down or "
                "failed); reinitialize before submitting collectives")

    def add(self, entry: TensorTableEntry, request: Request) -> None:
        # The submission's fault site, before the lock: a delay here makes
        # this rank a compute straggler while its peers keep negotiating.
        if faults.ACTIVE:
            faults.inject("enqueue.collective")
        # The tensor's lifecycle opens here; the response that collects
        # it closes LC_SUBMITTED (core/state.py).
        timeline_mod.lifecycle_begin(entry.tensor_name, "LC_SUBMITTED")
        with self._lock:
            self._check_open()
            if entry.tensor_name in self._table:
                raise DuplicateNameError(
                    f"tensor {entry.tensor_name!r} already in flight; collective "
                    f"names must be unique until the previous op completes")
            self._table[entry.tensor_name] = entry
            self._pending.append(request)
        if self._wake is not None:
            self._wake.set()

    def push_message(self, request: Request) -> None:
        """Queue a request that has no entry (JOIN) ahead of the pending
        ones, as the JAX package's ``push_messages`` does."""
        with self._lock:
            self._check_open()
            self._pending.insert(0, request)
        if self._wake is not None:
            self._wake.set()

    def close(self) -> None:
        """Reject all future adds; called before the final drain."""
        with self._lock:
            self._closed = True

    def pop_messages(self) -> List[Request]:
        """Drain pending requests (``PopMessagesFromQueue``,
        ``tensor_queue.h:44``)."""
        with self._lock:
            out, self._pending = self._pending, []
            return out

    def get_entries_for_response(self, response: Response) -> List[TensorTableEntry]:
        """Claim (remove) the entries a Response names; a name this rank
        never enqueued (a joined rank's) has none."""
        with self._lock:
            return [self._table.pop(name) for name in response.tensor_names
                    if name in self._table]

    def remove(self, name: str) -> Optional[TensorTableEntry]:
        with self._lock:
            return self._table.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._table)
