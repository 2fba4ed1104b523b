"""Carry flax weights into the port's modules.

``from_flax(params, batch_stats)`` takes the nested dicts of **numpy**
arrays that flax's ``variables["params"]`` / ``variables["batch_stats"]``
hold (so it needs no JAX) and returns a ``state_dict`` for
:class:`horovod_tpu_torch.models.resnet.ResNet` or
:class:`horovod_tpu_torch.models.transformer.Transformer`.  The port names
its submodules after flax's names, so the key paths match one to one; only
layouts change: conv kernels HWIO → OIHW, the ResNet's ``Dense_0`` kernel
``[in, out]`` → ``[out, in]``.  ``FusedConv1x1BN`` and the transformer's
``Dense`` modules (``qkv``, ``out``, ``ffn_in``, ``ffn_out``) keep flax's
``[in, out]`` kernels.  Leaves still boxed in ``nn.Partitioned`` (the
transformer's ``nn.with_partitioning`` annotations) are unboxed here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, value


def _convert(path: str, value) -> torch.Tensor:
    if hasattr(value, "unbox"):  # flax nn.Partitioned, without importing it
        value = value.unbox()
    arr = np.array(value, dtype=np.float32)  # a writable copy
    module, _, leaf = path.rpartition(".")
    if leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and module.rpartition(".")[2].startswith("Dense"):
        arr = arr.T
    return torch.from_numpy(np.ascontiguousarray(arr))


def from_flax(params: Mapping[str, Any],
              batch_stats: Optional[Mapping[str, Any]] = None
              ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) → the port's ``state_dict``."""
    state = {path: _convert(path, v) for path, v in _flatten(params)}
    for path, v in _flatten(batch_stats or {}):
        state[path] = _convert(path, v)
    return state
