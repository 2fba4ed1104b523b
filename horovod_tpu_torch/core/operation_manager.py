"""Ordered backend dispatch — first enabled op wins.

Counterpart of ``horovod_tpu/core/operation_manager.py`` (the reference's
``OperationManager``, ``operation_manager.cc:41-121``): each response type
has an ordered chain of candidate ops; the first whose ``enabled()`` holds
executes.
"""

from __future__ import annotations

from typing import Dict, List

from .messages import Response, ResponseType
from .tensor_queue import Status, TensorTableEntry


class CollectiveOp:
    """Base op: ``HorovodOp::Execute(entries, response)`` + ``Enabled(...)``
    (reference ``collective_operations.h:38-87``)."""

    def enabled(self, response: Response,
                entries: List[TensorTableEntry]) -> bool:
        raise NotImplementedError

    def execute(self, response: Response,
                entries: List[TensorTableEntry]) -> Status:
        raise NotImplementedError


class OperationManager:
    def __init__(self):
        self._chains: Dict[ResponseType, List[CollectiveOp]] = {
            t: [] for t in ResponseType
        }

    def register(self, response_type: ResponseType, op: CollectiveOp) -> None:
        self._chains[response_type].append(op)

    def execute(self, response: Response,
                entries: List[TensorTableEntry]) -> Status:
        for op in self._chains[response.response_type]:
            if op.enabled(response, entries):
                return op.execute(response, entries)
        return Status.error(
            f"no enabled backend op for {response.response_type.name}")
