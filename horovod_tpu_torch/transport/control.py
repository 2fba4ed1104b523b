"""The byte exchange of the negotiation rounds, over the gloo control group.

The JAX package's star sends each worker's cycle payload to rank 0 and rank
0's verdict back over its own TCP mesh (``horovod_tpu/core/controller.py``
``_worker_round`` / ``_gather_request_lists`` /
``_broadcast_response_payload``).  The port makes the same exchange with
``torch.distributed`` collectives on a gloo group, the role of Horovod's
GlooController: payloads are padded to the widest rank's length for the
gather, so each round costs four collectives (lengths, payloads, the
verdict's length, the verdict).

The group is the runtime's own (:func:`gloo_group`), built on the
launcher's store and called through its methods: torch.distributed's
default process group stays the user's, to initialize or not.

Every wait on a host-plane collective goes through :func:`wait`, which
:func:`abort` can interrupt: the elastic runtime's teardown and the
driver's reshard ping (``core/state.py``) unblock a rank whose collective
waits on a peer that is gone or leaving.  Gloo itself notices a peer's
closed connection at once, but not a host that vanished from the network,
nor a peer that is alive and will never join.  Point-to-point sends and
receives are waited on whole: gloo ends a send or receive whose timed
wait runs out, and closes its pair.
"""

from __future__ import annotations

import datetime
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from ..common.exceptions import HorovodInternalError

# How often a blocked wait looks at the abort flag.
_ABORT_POLL = datetime.timedelta(milliseconds=100)
_abort_lock = threading.Lock()
_abort_reason: Optional[str] = None


def abort(reason: str) -> None:
    """Make every host-plane wait in this process raise
    ``HorovodInternalError(reason)`` within ~0.1 s, until :func:`clear_abort`."""
    global _abort_reason
    with _abort_lock:
        _abort_reason = reason


def abort_reason() -> Optional[str]:
    """The reason given to :func:`abort`, or None."""
    return _abort_reason


def clear_abort() -> None:
    """A new runtime's groups start unaborted."""
    global _abort_reason
    with _abort_lock:
        _abort_reason = None


def wait(work) -> None:
    """A collective's ``work.wait()``, in slices, raising once :func:`abort`
    was called (never a send's or a receive's: module docstring).
    A slice that ends before the work does raises gloo's "timed out" and
    leaves the work running; a work that has completed by then is waited
    on once more, which returns or raises the work's own error."""
    while True:
        try:
            work.wait(_ABORT_POLL)
            return
        except RuntimeError:
            if work.is_completed():
                work.wait()
                return
            reason = _abort_reason
            if reason is not None:
                raise HorovodInternalError(reason) from None


def gloo_group(store: "dist.Store", rank: int, size: int,
               timeout: float) -> "dist.ProcessGroupGloo":
    """A gloo group of ``size`` ranks that rendezvouses through ``store``;
    its collectives fail after ``timeout`` seconds."""
    return dist.ProcessGroupGloo(store, rank, size,
                                 datetime.timedelta(seconds=timeout))


def _tensor(payload: bytes, width: int) -> torch.Tensor:
    buf = torch.zeros(width, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    return buf


class ControlPlane:
    """Star gather to rank 0 and broadcast from rank 0 of byte payloads on
    ``group`` (:func:`gloo_group`).  Every rank calls both once per cycle,
    in the same order."""

    def __init__(self, rank: int, size: int, group):
        self.rank = rank
        self.size = size
        self.group = group
        self._root = dist.GatherOptions()
        self._root.rootRank = 0
        self._source = dist.BroadcastOptions()
        self._source.rootRank = 0

    def gather(self, payload: bytes) -> Optional[List[bytes]]:
        """Every rank's payload, in rank order, at rank 0; None elsewhere."""
        mine = torch.tensor([len(payload)], dtype=torch.int64)
        lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        wait(self.group.allgather([lengths], [mine]))
        lengths = [int(n.item()) for n in lengths]
        width = max(lengths)
        bufs = [torch.empty(width, dtype=torch.uint8)
                for _ in range(self.size)] if self.rank == 0 else []
        wait(self.group.gather([bufs] if self.rank == 0 else [],
                               [_tensor(payload, width)], self._root))
        if self.rank != 0:
            return None
        return [buf[:n].numpy().tobytes() for buf, n in zip(bufs, lengths)]

    def broadcast(self, payload: Optional[bytes]) -> bytes:
        """Rank 0's ``payload`` on every rank."""
        n = torch.tensor([len(payload) if self.rank == 0 else 0],
                         dtype=torch.int64)
        wait(self.group.broadcast([n], self._source))
        buf = _tensor(payload if self.rank == 0 else b"", int(n.item()))
        wait(self.group.broadcast([buf], self._source))
        return payload if self.rank == 0 else buf.numpy().tobytes()
