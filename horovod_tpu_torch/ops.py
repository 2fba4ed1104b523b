"""Eager collective API over torch tensors.

Counterpart of ``horovod_tpu/frameworks/jax/ops.py`` with the torch surface
of ``horovod_tpu/frameworks/torch/__init__.py:94-195`` (the reference's
``horovod/torch/mpi_ops.py:85-630``): blocking and ``*_async`` allreduce,
broadcast and allgather, the in-place ``_`` flavors, ``alltoall``,
``join``, ``barrier``, ``poll``, ``synchronize`` and
``synchronize_many``.  Average is a
postscale of 1/size, like the reference (``operations.cc:953-956``);
Adasum (``backend/adasum.py``) takes the scales as given and floating-point
tensors only.

The out-of-place flavors also take what the JAX bridge's ``_to_numpy``
takes (numpy arrays, lists, Python scalars) and return CPU tensors for it;
the in-place flavors write into the torch tensor they are given.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from .common.exceptions import HorovodInternalError
from .core.handle_manager import HandleManager
from .core.messages import RequestType
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
    if op not in (Sum, Average, Adasum):
        raise ValueError(f"unknown reduce op {op!r}")
    return op


def _as_tensor(tensor) -> torch.Tensor:
    """A torch tensor as it is; an array-like as a new CPU tensor of the
    dtype numpy gives it (float64 for Python floats, as in the JAX
    bridge)."""
    if isinstance(tensor, torch.Tensor):
        return tensor
    return torch.from_numpy(np.array(tensor))


def _submit(enqueue) -> int:
    """Allocate a handle and run ``enqueue(callback)``; a call that never
    made it into the queue releases its handle and re-raises."""
    handle = _handles.allocate()
    try:
        enqueue(_callback(handle))
    except BaseException:
        _handles.discard(handle)
        raise
    return handle


def _callback(handle: int):
    def cb(status: Status, entry):
        _handles.mark_done(handle, status, entry.output if status.ok else None)
    return cb


def _allreduce_async(tensor: torch.Tensor, output: Optional[torch.Tensor],
                     average, name, op, prescale_factor,
                     postscale_factor) -> int:
    state = global_state()
    state._check_initialized()
    op = _resolve_op(average, op)
    tensor = _as_tensor(tensor)
    if op == Average:
        postscale_factor = postscale_factor / state.topo.size
    if op == Adasum and not tensor.is_floating_point():
        # The JAX host plane would combine in floats and cast back: a
        # result that means nothing for integers.
        raise ValueError(f"Adasum combines floating-point tensors, got "
                         f"{tensor.dtype}; use Sum or Average")
    name = _auto_name("allreduce", name)
    return _submit(lambda cb: state.enqueue_allreduce(
        name, tensor, cb, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, output=output,
        op=RequestType.ADASUM if op == Adasum else RequestType.ALLREDUCE))


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


def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    """Start an allgather along the first dimension; the ranks' first
    dimensions may differ, the others must agree."""
    state = global_state()
    name = _auto_name("allgather", name)
    return _submit(lambda cb: state.enqueue_allgather(
        name, _as_tensor(tensor), cb))


def allgather(tensor: torch.Tensor, name: Optional[str] = None
              ) -> torch.Tensor:
    """Every rank's tensor, concatenated along the first dimension in rank
    order."""
    return synchronize(allgather_async(tensor, name=name))


def _broadcast_async(tensor, output, root_rank: int,
                     name: Optional[str]) -> int:
    state = global_state()
    name = _auto_name("broadcast", name)
    return _submit(lambda cb: state.enqueue_broadcast(
        name, _as_tensor(tensor), root_rank, cb, output=output))


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    """Start a broadcast of ``root_rank``'s tensor; :func:`synchronize`
    returns a new tensor."""
    return _broadcast_async(tensor, None, root_rank, name)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name=name))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> int:
    """In-place flavor: ``root_rank``'s values are written into
    ``tensor``."""
    return _broadcast_async(tensor, tensor, root_rank, name)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name=name))


def alltoall(tensor: torch.Tensor, splits: Optional[List[int]] = None,
             name: Optional[str] = None) -> torch.Tensor:
    """Send ``splits[r]`` rows to rank r (equal shares when None) and return
    the rows received, in rank order."""
    state = global_state()
    name = _auto_name("alltoall", name)
    return synchronize(_submit(lambda cb: state.enqueue_alltoall(
        name, _as_tensor(tensor), splits, cb)))


def join() -> int:
    """Block until every rank has joined; meanwhile this rank contributes
    zeros to the allreduces of the others (reference ``hvd.join``,
    ``operations.cc:1146-1170``).  Returns 0, as the JAX bridge does."""
    global_state().enqueue_join().wait()
    return 0


def barrier(name: Optional[str] = None) -> None:
    """Block until every rank has reached this barrier; raises on an error
    status."""
    done = threading.Event()
    status_box = []

    def cb(status: Status, entry) -> None:
        status_box.append(status)
        done.set()

    global_state().enqueue_barrier(cb, name=_auto_name("barrier", name))
    done.wait()
    if not status_box[0].ok:
        raise HorovodInternalError(status_box[0].error_message)


def size_or_one() -> int:
    """World size, or 1 when the runtime is not initialized."""
    state = global_state()
    return state.topo.size if state.topo is not None else 1


def initialized() -> bool:
    """True when ``hvd.init()`` has completed and the runtime is live."""
    return global_state().topo is not None


def poll(handle: int) -> bool:
    """True when the async op behind ``handle`` completed
    (reference ``mpi_ops_v2.cc:323``)."""
    return _handles.poll(handle)


def synchronize(handle: int, timeout: Optional[float] = None) -> torch.Tensor:
    """Wait for an async op and return its result (the submitted tensor for
    the in-place flavors).  A CUDA result is complete on the card when this
    returns."""
    return _handles.wait(handle, timeout=timeout)


def synchronize_many(handles, timeout: Optional[float] = None) -> list:
    """Wait for a batch of async ops; their results in handle order, under
    one deadline for the whole batch (``frameworks/jax/ops.py:240``).  On
    any error or timeout every handle is released before this raises."""
    return _handles.wait_many(list(handles), timeout=timeout)
