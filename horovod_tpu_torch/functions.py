"""Parameter, optimizer-state and object broadcast, and object allgather.

Counterpart of ``horovod_tpu/frameworks/jax/functions.py`` with the torch
surface of ``horovod_tpu/frameworks/torch/__init__.py:197-262`` (the
reference's ``horovod/torch/functions.py:30-257``): fan a restored
checkpoint, or rank 0's initial weights, out to every rank at start-up,
and move picklable objects as uint8 tensors.  The tensor names are the JAX
bridge's, so both packages negotiate the same names.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from . import ops
from .basics import rank, size
from .common import pickling


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a ``state_dict`` or an iterable of ``(name, tensor)`` from
    ``root_rank``, in place (reference ``functions.py:30``)."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    handles = [ops.broadcast_async_(p.data, root_rank,
                                    name=f"bcast.param.{name}")
               for name, p in items if isinstance(p, torch.Tensor)]
    for h in handles:
        ops.synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Broadcast an optimizer's hyperparameters and state from
    ``root_rank`` (reference ``functions.py:62``): ``param_groups`` as one
    object, every non-empty state tensor in place, and the rest of the
    state (Python numbers, empty tensors) as one object; then load the
    result."""
    state_dict = optimizer.state_dict()
    state_dict["param_groups"] = broadcast_object(
        state_dict["param_groups"], root_rank=root_rank,
        name="bcast.opt.param_groups")
    scalars = {}
    handles = []
    for pid, pstate in sorted(state_dict.get("state", {}).items()):
        for key, value in sorted(pstate.items()):
            if isinstance(value, torch.Tensor) and value.numel() > 0:
                handles.append(ops.broadcast_async_(
                    value, root_rank, name=f"bcast.opt.{pid}.{key}"))
            else:
                scalars[(pid, key)] = value
    for h in handles:
        ops.synchronize(h)
    synced = broadcast_object(scalars, root_rank=root_rank,
                              name="bcast.opt.scalars")
    for (pid, key), value in synced.items():
        state_dict["state"][pid][key] = value
    optimizer.load_state_dict(state_dict)


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s object on every rank: pickled, its length and then
    its bytes broadcast, unpickled (reference ``functions.py:186-224``)."""
    name = name or "torch.bcast_obj"
    if rank() == root_rank:
        payload = torch.frombuffer(bytearray(pickling.dumps(obj)),
                                   dtype=torch.uint8)
    else:
        payload = torch.empty(0, dtype=torch.uint8)
    n = ops.broadcast(torch.tensor([payload.numel()], dtype=torch.int64),
                      root_rank, name=f"{name}.size")
    if rank() != root_rank:
        payload = torch.zeros(int(n[0]), dtype=torch.uint8)
    data = ops.broadcast(payload, root_rank, name=f"{name}.data")
    return pickling.loads(data.numpy().tobytes())


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """Every rank's picklable object, in rank order (reference
    ``functions.py:227-257``)."""
    name = name or "torch.allgather_obj"
    payload = torch.frombuffer(bytearray(pickling.dumps(obj)),
                               dtype=torch.uint8)
    sizes = ops.allgather(torch.tensor([payload.numel()], dtype=torch.int64),
                          name=f"{name}.size")
    data = ops.allgather(payload, name=f"{name}.data").numpy()
    out, offset = [], 0
    for r in range(size()):
        n = int(sizes[r])
        out.append(pickling.loads(data[offset:offset + n].tobytes()))
        offset += n
    return out
