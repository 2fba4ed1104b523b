"""Eager collective API over torch tensors.

Counterpart of ``horovod_tpu/frameworks/jax/ops.py`` with the torch surface
of ``horovod_tpu/frameworks/torch/__init__.py:94-156`` (the reference's
``horovod/torch/mpi_ops.py:85-630``): blocking and ``*_async`` allreduce,
the in-place ``_`` flavors, ``poll`` and ``synchronize``.  Average is a
postscale of 1/size, like the reference (``operations.cc:953-956``).
Allgather, broadcast, alltoall, join and barrier arrive with later slices
(ROADMAP.md).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .core.handle_manager import HandleManager
from .core.state import global_state
from .core.tensor_queue import Status

# Reduce-op constants (reference ``horovod/torch/mpi_ops.py``).
Sum = "sum"
Average = "average"
Adasum = "adasum"

_handles = HandleManager()
_name_lock = threading.Lock()
_name_counters = {}


def _auto_name(kind: str, name: Optional[str]) -> str:
    """Deterministic auto-naming: relies on identical call order across
    ranks, the same contract the reference's bindings use."""
    if name is not None:
        return name
    with _name_lock:
        n = _name_counters.get(kind, 0)
        _name_counters[kind] = n + 1
    return f"{kind}.noname.{n}"


def _resolve_op(average: Optional[bool], op: Optional[str]) -> str:
    if op is None:
        op = Average if (average or average is None) else Sum
    elif average is not None:
        raise ValueError("specify either average or op, not both")
    if op == Adasum:
        raise NotImplementedError(
            "Adasum arrives with its own slice of the port (ROADMAP.md, "
            "queue A, Adasum); use Sum or Average")
    if op not in (Sum, Average):
        raise ValueError(f"unknown reduce op {op!r}")
    return op


def _callback(handle: int):
    def cb(status: Status, entry):
        _handles.mark_done(handle, status, entry.output if status.ok else None)
    return cb


def _allreduce_async(tensor: torch.Tensor, output: Optional[torch.Tensor],
                     average, name, op, prescale_factor,
                     postscale_factor) -> int:
    state = global_state()
    state._check_initialized()
    if _resolve_op(average, op) == Average:
        postscale_factor = postscale_factor / state.topo.size
    name = _auto_name("allreduce", name)
    handle = _handles.allocate()
    try:
        state.enqueue_allreduce(name, tensor, _callback(handle),
                                prescale_factor=prescale_factor,
                                postscale_factor=postscale_factor,
                                output=output)
    except BaseException:
        # Never made it into the queue: release the handle, then re-raise.
        _handles.discard(handle)
        raise
    return handle


def allreduce_async(tensor: torch.Tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[str] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Start an allreduce; :func:`synchronize` returns a new tensor."""
    return _allreduce_async(tensor, None, average, name, op,
                            prescale_factor, postscale_factor)


def allreduce(tensor: torch.Tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[str] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    return synchronize(allreduce_async(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor))


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None, op: Optional[str] = None,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0) -> int:
    """In-place flavor: the result is written into ``tensor``; do not touch
    it until :func:`synchronize` returns it."""
    return _allreduce_async(tensor, tensor, average, name, op,
                            prescale_factor, postscale_factor)


def allreduce_(tensor: torch.Tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op: Optional[str] = None,
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    return synchronize(allreduce_async_(
        tensor, average=average, name=name, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor))


def poll(handle: int) -> bool:
    """True when the async op behind ``handle`` completed
    (reference ``mpi_ops_v2.cc:323``)."""
    return _handles.poll(handle)


def synchronize(handle: int, timeout: Optional[float] = None) -> torch.Tensor:
    """Wait for an async op and return its result (the submitted tensor for
    the in-place flavors).  A CUDA result is complete on the card when this
    returns."""
    return _handles.wait(handle, timeout=timeout)
