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
"""

from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist


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
        self.group.allgather([lengths], [mine]).wait()
        lengths = [int(n.item()) for n in lengths]
        width = max(lengths)
        bufs = [torch.empty(width, dtype=torch.uint8)
                for _ in range(self.size)] if self.rank == 0 else []
        self.group.gather([bufs] if self.rank == 0 else [],
                          [_tensor(payload, width)], self._root).wait()
        if self.rank != 0:
            return None
        return [buf[:n].numpy().tobytes() for buf, n in zip(bufs, lengths)]

    def broadcast(self, payload: Optional[bytes]) -> bytes:
        """Rank 0's ``payload`` on every rank."""
        n = torch.tensor([len(payload) if self.rank == 0 else 0],
                         dtype=torch.int64)
        self.group.broadcast([n], self._source).wait()
        buf = _tensor(payload if self.rank == 0 else b"", int(n.item()))
        self.group.broadcast([buf], self._source).wait()
        return payload if self.rank == 0 else buf.numpy().tobytes()
