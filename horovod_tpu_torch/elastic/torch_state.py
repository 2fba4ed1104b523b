"""Elastic training state for PyTorch: ``TorchState`` and ``ElasticSampler``.

The port's copy of ``horovod_tpu/frameworks/torch/elastic.py`` (reference
``torch/elastic/state.py:27-178``, ``torch/elastic/sampler.py:24-131``): a
``TorchState`` sorts its keyword arguments into typed handlers (a model:
state-dict snapshot and parameter broadcast; an optimizer: state-dict
snapshot and optimizer-state broadcast; an ``ElasticSampler``: the union of
the processed indices across the world), and an ``ElasticSampler`` shards
a dataset over the current world and, after a reset, reshards only the
indices not yet processed in the epoch.

Where the JAX bridge's handlers sync from rank 0 only, these take the
``root_rank`` that ``_sync_for_epoch`` picks; the optimizer handler first
gives a rank whose optimizer has no state yet (a joiner that never
stepped) zero tensors of the root's shapes, so that
``broadcast_optimizer_state`` names the same tensors on every rank; and a
restore drops a ``DistributedOptimizer``'s allreduces in flight, which
died with the old world.
"""

from __future__ import annotations

import copy
import math
import random
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.utils.data

from ..basics import rank, size
from ..functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from ..optimizer import _DistributedAdasumOptimizer, _DistributedOptimizer
from .state import ObjectState, run  # noqa: F401  (run: re-export)


class ElasticSampler(torch.utils.data.Sampler):
    """Shards a fixed-size dataset across the live world, tracking which
    indices this epoch already consumed so a mid-epoch reshard (rank set
    changed) hands out only the remainder.

    Usage contract (reference ``sampler.py:24-60``): register it on a
    :class:`TorchState`, call :meth:`record_batch` after each processed
    batch, and :meth:`set_epoch` at the **end** of each epoch (clearing the
    processed set at the start would make a partially-trained epoch repeat
    samples after a reset).
    """

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: set = set()
        self.reset()

    # -- elastic hooks --------------------------------------------------

    def reset(self) -> None:
        """Re-read rank/size and rebuild this worker's shard from whatever
        indices remain unprocessed this epoch."""
        self.rank = rank()
        self.num_replicas = size()
        self.remaining_indices = [
            i for i in range(len(self.dataset))
            if i not in self.processed_indices
        ]
        # Pad to a common per-rank length (every rank must step the same
        # number of batches or collectives desynchronize).
        self.num_samples = math.ceil(
            len(self.remaining_indices) / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        self.record_indices(self.get_indices(batch_idx, batch_size))

    def record_indices(self, indices) -> None:
        self.processed_indices.update(indices)

    def get_indices(self, batch_idx: int, batch_size: int) -> list:
        start = batch_idx * batch_size
        return self.indices[start:min(start + batch_size, len(self.indices))]

    # -- (de)serialization ----------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch,
                "processed_indices": self.processed_indices}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.epoch = state_dict["epoch"]
        self.processed_indices = set(state_dict["processed_indices"])
        self.reset()

    # -- sampling -------------------------------------------------------

    def __iter__(self) -> Iterator[int]:
        pool = list(self.remaining_indices)
        if self.shuffle:
            # Same permutation on every rank: seeded by (seed, epoch) only.
            random.Random(self.seed + self.epoch).shuffle(pool)
        # Wrap-around pad (may need multiple passes when replicas >
        # remaining): every rank must see exactly num_samples indices or
        # per-rank batch counts diverge and collectives desynchronize.
        while pool and len(pool) < self.total_size:
            pool += pool[:self.total_size - len(pool)]
        self.indices = pool[self.rank::self.num_replicas]
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples


# ---------------------------------------------------------------------------
# typed state handlers
# ---------------------------------------------------------------------------


class StateHandler:
    """Per-type save/restore/sync strategy (reference ``state.py:72-90``)."""

    def __init__(self, value):
        self.value = value

    def set_value(self, value) -> None:
        self.value = value
        self.save()

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self, root_rank: int = 0) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        """Adopt the post-rendezvous world (rank/size may have changed).
        Called from ``State.on_reset`` AFTER re-initialization — runs even
        on the skip-sync (hosts-added-only) path, where nothing else would
        reshard a sampler."""


class ModelStateHandler(StateHandler):
    def __init__(self, model):
        super().__init__(model)
        self.save()

    def save(self) -> None:
        self._snapshot = copy.deepcopy(self.value.state_dict())

    def restore(self) -> None:
        self.value.load_state_dict(self._snapshot)

    def sync(self, root_rank: int = 0) -> None:
        broadcast_parameters(self.value.state_dict(), root_rank=root_rank)


class OptimizerStateHandler(StateHandler):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.save()

    def save(self) -> None:
        self._snapshot = copy.deepcopy(self.value.state_dict())

    def restore(self) -> None:
        self.value.load_state_dict(self._snapshot)
        # The allreduces a DistributedOptimizer had in flight died with the
        # old world's runtime.
        drop = getattr(self.value, "drop_in_flight", None)
        if drop is not None:
            drop()

    def sync(self, root_rank: int = 0) -> None:
        _align_optimizer_state(self.value, root_rank)
        broadcast_optimizer_state(self.value, root_rank=root_rank)


class SamplerStateHandler(StateHandler):
    def __init__(self, sampler):
        super().__init__(sampler)
        self.save()

    def save(self) -> None:
        self._snapshot = copy.deepcopy(self.value.state_dict())

    def restore(self) -> None:
        self.value.load_state_dict(self._snapshot)

    def reset(self) -> None:
        self.value.reset()

    def sync(self, root_rank: int = 0) -> None:
        # A worker that died may have recorded indices nobody else saw —
        # the union across the live world is the safe "already processed"
        # set (reference ``SamplerStateHandler.sync``).
        merged: set = set()
        for s in allgather_object(self.value.processed_indices,
                                  name="elastic.sampler.processed"):
            merged |= set(s)
        state = self.value.state_dict()
        state["processed_indices"] = merged
        self.value.load_state_dict(
            broadcast_object(state, root_rank=root_rank,
                             name="elastic.sampler.state"))


def _align_optimizer_state(optimizer, root_rank: int) -> None:
    """Give this rank's optimizer a state entry, of zeros, for every tensor
    the root's holds and this one lacks (a process that joined and never
    stepped has none), so that every rank broadcasts the same tensors.
    The root's layout travels as one object: per parameter index, each
    state key's shape, dtype and device type, or its Python value."""
    layout = None
    if rank() == root_rank:
        layout = {pid: {k: (tuple(v.shape), str(v.dtype).split(".")[-1],
                            v.device.type)
                        if isinstance(v, torch.Tensor) else ("value", v, None)
                        for k, v in pstate.items()}
                  for pid, pstate in optimizer.state_dict()["state"].items()}
    layout = broadcast_object(layout, root_rank=root_rank,
                              name="elastic.optimizer.layout")
    if rank() == root_rank:
        return
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = optimizer.state
    for pid, keys in layout.items():
        pstate = state[params[pid]]
        for key, (shape, dtype, devtype) in keys.items():
            if key in pstate:
                continue
            if shape == "value":
                pstate[key] = dtype
                continue
            # A 0-d step counter lies where the root's does: on the CPU
            # unless the optimizer is capturable or fused.
            dev = params[pid].device if devtype != "cpu" else "cpu"
            pstate[key] = torch.zeros(shape, dtype=getattr(torch, dtype),
                                      device=dev)


_handler_registry = [
    (torch.nn.Module, ModelStateHandler),
    (torch.optim.Optimizer, OptimizerStateHandler),
    # hvd.DistributedOptimizer's wrappers, which forward to the optimizer.
    (_DistributedOptimizer, OptimizerStateHandler),
    (_DistributedAdasumOptimizer, OptimizerStateHandler),
    (ElasticSampler, SamplerStateHandler),
]


def get_handler_registry():
    return list(_handler_registry)


def set_handler_registry(registry) -> None:
    global _handler_registry
    _handler_registry = list(registry)


def _build_handlers(kwargs: Dict[str, Any]) -> Tuple[Dict[str, StateHandler],
                                                     Dict[str, Any]]:
    handlers, plain = {}, {}
    for key, value in kwargs.items():
        for typ, cls in _handler_registry:
            if isinstance(value, typ):
                handlers[key] = cls(value)
                break
        else:
            plain[key] = value
    return handlers, plain


class TorchState(ObjectState):
    """Elastic state for PyTorch training (reference ``state.py:27-69``).

    Any number of models/optimizers/samplers may be passed as kwargs; each
    gets a typed handler (registry-extensible via
    :func:`set_handler_registry`), everything else syncs as a pickled
    object through the coordinator.
    """

    def __init__(self, model=None, optimizer=None, **kwargs):
        if model is not None:
            kwargs["model"] = model
        if optimizer is not None:
            kwargs["optimizer"] = optimizer
        handlers, plain = _build_handlers(kwargs)
        # Bypass __setattr__'s handler hook while bootstrapping.
        object.__setattr__(self, "_handlers", handlers)
        for name, handler in handlers.items():
            object.__setattr__(self, name, handler.value)
        super().__init__(**plain)

    def save(self) -> None:
        for handler in self._handlers.values():
            handler.save()
        super().save()

    def restore(self) -> None:
        for handler in self._handlers.values():
            handler.restore()
        super().restore()

    def sync(self, root_rank: int = 0) -> None:
        for handler in self._handlers.values():
            handler.sync(root_rank)
        super().sync(root_rank)

    def reset(self) -> None:
        for handler in self._handlers.values():
            handler.reset()
        super().reset()

    def __setattr__(self, name: str, value) -> None:
        # Re-pointing a handled attribute (state.model = new_model) must
        # re-point and re-snapshot its handler too.
        handlers = getattr(self, "_handlers", None)
        if handlers and name in handlers:
            handlers[name].set_value(value)
        object.__setattr__(self, name, value)


__all__ = [
    "ElasticSampler",
    "ModelStateHandler",
    "OptimizerStateHandler",
    "SamplerStateHandler",
    "StateHandler",
    "TorchState",
    "get_handler_registry",
    "run",
    "set_handler_registry",
]
