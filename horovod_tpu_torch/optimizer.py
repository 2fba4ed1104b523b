"""DistributedOptimizer: a ``torch.optim`` wrapper that allreduces every
gradient through the runtime.

Counterpart of ``horovod_tpu/frameworks/jax/optimizer.py:181-398`` with the
torch surface of ``horovod_tpu/frameworks/torch/__init__.py:292-410`` (the
reference's ``horovod/torch/optimizer.py:103-200``).  A hook on each
parameter fires the moment autograd has accumulated that parameter's
gradient and enqueues an in-place ``allreduce_async_`` of it, so the
runtime reduces gradients while the rest of backward runs.  ``step()``
synchronizes, then steps the wrapped optimizer.  With
``backward_passes_per_step=N`` the gradients of N backward passes accumulate
in ``p.grad`` and the allreduce's postscale of 1/N averages them.
``op=Adasum`` wraps it in the delta-space optimizer instead.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from . import ops
from .common.exceptions import HorovodInternalError
from .compression import Compression


class _DistributedOptimizer:
    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]],
                 compression, backward_passes_per_step: int, op: str,
                 prescale_factor: float, postscale_factor: float):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._bpps = backward_passes_per_step
        self._prescale = prescale_factor
        self._postscale = postscale_factor / backward_passes_per_step
        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = [(f"group{gi}.param{pi}", p)
                     for gi, group in enumerate(optimizer.param_groups)
                     for pi, p in enumerate(group["params"])]
        self._named: List[Tuple[str, torch.nn.Parameter]] = [
            (n, p) for n, p in named if p.requires_grad]
        if len({n for n, _ in self._named}) != len(self._named):
            raise ValueError("named_parameters contains duplicate names")
        self._counters: Dict[str, int] = {n: 0 for n, _ in self._named}
        # name -> (handle, compression context)
        self._handles: Dict[str, Tuple[int, object]] = {}
        for name, p in self._named:
            p.register_post_accumulate_grad_hook(self._make_hook(name))

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _make_hook(self, name: str):
        def hook(p: torch.nn.Parameter) -> None:
            if name in self._handles:
                raise HorovodInternalError(
                    f"gradient for {name} allreduced twice before step(); "
                    "increase backward_passes_per_step to accumulate "
                    "gradients (reference optimizer.py:136-141)")
            self._counters[name] += 1
            if self._counters[name] < self._bpps:
                return
            self._counters[name] = 0
            self._allreduce_grad_async(name, p.grad)
        return hook

    def _allreduce_grad_async(self, name: str, grad: torch.Tensor) -> None:
        comp, ctx = self._compression.compress(grad)
        handle = ops.allreduce_async_(
            comp, op=self._op, name=f"wfbp.{name}",
            prescale_factor=self._prescale, postscale_factor=self._postscale)
        self._handles[name] = (handle, ctx)

    def synchronize(self) -> None:
        """Wait for every gradient's allreduce and write the results into
        ``p.grad`` (reference ``optimizer.py:151-200``).  A parameter whose
        hook did not fire this step is submitted now with a zero gradient
        (other ranks may have submitted it), without materializing
        ``p.grad``."""
        for name, p in self._named:
            if name not in self._handles:
                self._counters[name] = 0
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                self._allreduce_grad_async(name, grad)
        for name, p in self._named:
            handle, ctx = self._handles.pop(name)
            out = self._compression.decompress(ops.synchronize(handle), ctx)
            if p.grad is None:
                # Every rank saw no gradient: keep torch's grad-None skip
                # unless another rank contributed.
                if not bool((out != 0).any()):
                    continue
                p.grad = torch.zeros_like(p)
            if out is not p.grad:
                with torch.no_grad():
                    p.grad.copy_(out)

    def step(self, closure=None):
        if self._handles:
            self.synchronize()
        return self._opt.step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise HorovodInternalError(
                "zero_grad() called while allreduces are outstanding; call "
                "step() or synchronize() first (reference "
                "optimizer.py:202-207)")
        return self._opt.zero_grad(*args, **kwargs)


class _DistributedAdasumOptimizer:
    """Adasum in delta space (the JAX bridge's
    ``horovod_tpu/frameworks/torch/__init__.py:413-465``; reference
    ``torch/optimizer.py:210-379``): ``step()`` runs the wrapped optimizer
    locally, then combines each parameter's step ``new − old`` across
    ranks with Adasum and applies the result to the old weights, merging
    whole optimizer steps instead of averaging gradients.  Like the bridge,
    it steps once and then reduces (the reference overlaps per-parameter
    steps with backward through hooks; element-wise optimizers give the
    same result either way)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]],
                 compression):
        self._opt = optimizer
        self._compression = compression
        self._names: Dict[torch.nn.Parameter, str] = \
            {p: n for n, p in named_parameters} \
            if named_parameters is not None else {}

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def synchronize(self) -> None:
        raise HorovodInternalError(
            "Skipping synchronization is not supported when using Adasum "
            "optimizer (reference optimizer.py:346)")

    def step(self, closure=None):
        old = {p: p.detach().clone()
               for group in self._opt.param_groups for p in group["params"]
               if p.grad is not None}
        loss = self._opt.step(closure)
        pending = []
        for gi, group in enumerate(self._opt.param_groups):
            for pi, p in enumerate(group["params"]):
                if p not in old:
                    continue
                name = self._names.get(p, f"group{gi}.param{pi}")
                comp, ctx = self._compression.compress(p.detach() - old[p])
                pending.append((p, ops.allreduce_async(
                    comp, op=ops.Adasum, name=f"adasum.delta.{name}"), ctx))
        for p, handle, ctx in pending:
            delta = self._compression.decompress(ops.synchronize(handle), ctx)
            with torch.no_grad():
                p.copy_(old[p] + delta.reshape(p.shape).to(p.dtype))
        return loss

    def zero_grad(self, *args, **kwargs):
        return self._opt.zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: str = ops.Average,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0):
    """Wrap ``optimizer`` so that ``step()`` applies gradients allreduced
    across ranks with ``op`` (Average or Sum), or, with ``op=Adasum``, its
    own steps combined across ranks by Adasum (the JAX bridge's factory,
    ``horovod_tpu/frameworks/torch/__init__.py:468-491``)."""
    if op == ops.Adasum:
        if backward_passes_per_step != 1:
            raise ValueError(
                "backward_passes_per_step > 1 is not supported with "
                "op=Adasum (the delta-space optimizer communicates whole "
                "optimizer steps; accumulate before calling step())")
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "op=Adasum takes no prescale_factor or postscale_factor: "
                "the delta-space optimizer combines whole optimizer steps")
        return _DistributedAdasumOptimizer(optimizer, named_parameters,
                                           compression)
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    return _DistributedOptimizer(
        optimizer, named_parameters, compression, backward_passes_per_step,
        op, prescale_factor, postscale_factor)
