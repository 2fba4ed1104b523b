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

``overlap=True`` (with ``backward_passes_per_step=K >= 2``) is the JAX
optimizer's microbatch-pipelined schedule (``frameworks/jax/optimizer.py``
``:181-398``): the hooks enqueue nothing; at the end of each backward pass
every hooked parameter's ``p.grad`` (zeros where it is None) goes to the
runtime as one fused tree per dtype (``wfbp.enqueue_tree_fused``), named
``{root}.mb{i}``, and ``p.grad`` is zeroed, so the runtime reduces
microbatch i while the caller runs backward i+1; ``step()`` waits on the
window's K trees, writes their sum times 1/K into ``p.grad`` and steps.
The calling contract stays torch's: K backward passes, then one
``step()``.  The JAX optimizer's ``update`` is called once per microbatch
and returns zero updates until the K-th; here the K-th call's work is
``step()``'s.  Every instance draws its own wire root (``grad.opt{n}``)
at its first communicating step, so two optimizers in one process never
collide on a name; the ranks must build their communicating optimizers in
the same order, the JAX contract.

:func:`distributed_value_and_grad` is the JAX package's
``distributed_value_and_grad`` (``:452-468``) for a function of a tree of
tensors.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from . import ops, wfbp
from .common.exceptions import HorovodInternalError
from .common.logging_util import get_logger
from .compression import Compression

log = get_logger("horovod_tpu_torch.optimizer")

_instance_ids = itertools.count()

# Abandoned overlap windows (a desync, an exception mid-window) leave
# collectives in flight that may never complete when the abandonment was
# one rank's alone; the training path must not block on them.  They go to
# one shared named daemon, which polls without blocking, releases the ones
# that complete and drops the rest after a deadline.
_DRAIN_TIMEOUT_S = 120.0
_drain_lock = threading.Lock()
_drain_queue: list = []      # (handle, deadline, timeout) triples
_drain_thread: Optional[threading.Thread] = None


def _drain_handles_async(handles, timeout_s: float = _DRAIN_TIMEOUT_S) -> None:
    global _drain_thread
    deadline = time.monotonic() + timeout_s
    with _drain_lock:
        _drain_queue.extend((h, deadline, timeout_s) for h in handles)
        if _drain_queue and (_drain_thread is None
                             or not _drain_thread.is_alive()):
            _drain_thread = threading.Thread(
                target=_drain_loop, name="hvd-window-drainer", daemon=True)
            _drain_thread.start()


def _drain_loop() -> None:
    global _drain_thread
    while True:
        with _drain_lock:
            items, _drain_queue[:] = list(_drain_queue), []
        keep = []
        for h, deadline, timeout_s in items:
            if ops.poll(h):
                try:
                    ops.synchronize(h)      # completed: releases the handle
                except Exception as e:  # noqa: BLE001 — unused result, but
                    # a failure points at an asymmetric rank error
                    log.debug("abandoned collective (handle %d) completed "
                              "with an error while draining: %s", h, e)
            elif time.monotonic() >= deadline:
                log.warning(
                    "dropping abandoned in-flight collective (handle %d): it "
                    "did not complete within %.1fs of its window's "
                    "abandonment, likely a failure on one rank only",
                    h, timeout_s)
                ops._handles.discard(h)
            else:
                keep.append((h, deadline, timeout_s))
        with _drain_lock:
            _drain_queue.extend(keep)
            if not _drain_queue:
                # Retire inside the lock: a hand-off that saw this thread
                # alive must not race its exit.
                _drain_thread = None
                return
        time.sleep(0.5)


class _DistributedOptimizer:
    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable[Tuple[str, torch.nn.Parameter]]],
                 compression, backward_passes_per_step: int, op: str,
                 prescale_factor: float, postscale_factor: float,
                 overlap: bool = False):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._bpps = backward_passes_per_step
        self._prescale = prescale_factor
        self._overlap = overlap
        # Overlap reduces each microbatch alone and averages at step().
        self._postscale = postscale_factor if overlap \
            else postscale_factor / backward_passes_per_step
        self._root: Optional[str] = None
        # Overlap: the window's fused trees in flight, and whether this
        # backward pass has queued its end-of-pass callback.
        self._window: List[wfbp.PendingTree] = []
        self._pass_queued = False
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
            p.register_post_accumulate_grad_hook(
                self._overlap_hook if overlap else self._make_hook(name))

    def __getattr__(self, item):
        return getattr(self._opt, item)

    def _name_root(self) -> str:
        """This instance's wire root, drawn at its first communicating
        step, so a rank-local optimizer that never communicates shifts no
        other's names."""
        if self._root is None:
            self._root = f"grad.opt{next(_instance_ids)}"
        return self._root

    # -- overlap=True: one fused tree per microbatch ----------------------

    def _overlap_hook(self, p: torch.nn.Parameter) -> None:
        if not self._pass_queued:
            self._pass_queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_of_pass)

    def _abandon_window(self, why: str) -> None:
        handles = [h for tree in self._window for h in tree.handles]
        self._window = []
        _drain_handles_async(handles)
        with torch.no_grad():
            for _, p in self._named:
                if p.grad is not None:
                    p.grad.zero_()
        raise HorovodInternalError(
            f"overlap window desync: {why} with "
            f"backward_passes_per_step={self._bpps}; overlap=True takes "
            "exactly that many backward passes before each step(), and the "
            "window's collectives in flight were abandoned")

    def _end_of_pass(self) -> None:
        """Autograd's end of this backward pass: enqueue every hooked
        gradient as one fused tree, then zero the gradients for the next
        microbatch."""
        self._pass_queued = False
        if len(self._window) == self._bpps:
            self._abandon_window(f"backward pass {self._bpps + 1} before "
                                 "step()")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self._named]
        self._window.append(wfbp.enqueue_tree_fused(
            grads, self._op, self._compression, self._prescale,
            self._postscale,
            name_prefix=f"{self._name_root()}.mb{len(self._window)}"))
        with torch.no_grad():
            for _, p in self._named:
                if p.grad is not None:
                    p.grad.zero_()

    def _flush_window(self) -> None:
        """Wait on the window's trees and write their sum times 1/K into
        ``p.grad``."""
        if len(self._window) != self._bpps:
            self._abandon_window(f"step() after {len(self._window)} backward "
                                 "passes")
        trees, self._window = [wfbp.wait_tree(t) for t in self._window], []
        scale = 1.0 / self._bpps
        with torch.no_grad():
            for i, (_, p) in enumerate(self._named):
                total = trees[0][i]
                for tree in trees[1:]:
                    total = total + tree[i]
                total = total * scale
                if p.grad is None:
                    p.grad = total.to(p.dtype)
                else:
                    p.grad.copy_(total)

    # -- the hooks: one allreduce per parameter ---------------------------

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
            comp, op=self._op, name=f"{self._name_root()}.{name}",
            prescale_factor=self._prescale, postscale_factor=self._postscale)
        self._handles[name] = (handle, ctx)

    def synchronize(self) -> None:
        """Wait for every gradient's allreduce and write the results into
        ``p.grad`` (reference ``optimizer.py:151-200``).  A parameter whose
        hook did not fire this step is submitted now with a zero gradient
        (other ranks may have submitted it), without materializing
        ``p.grad``.  With ``overlap=True``: wait on the window's fused
        trees."""
        if self._overlap:
            self._flush_window()
            return
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
        if self._handles or self._overlap:
            self.synchronize()
        return self._opt.step(closure)

    def drop_in_flight(self) -> None:
        """Forget the allreduces in flight and the counts toward
        ``backward_passes_per_step``: after an elastic reset they belong
        to a runtime that is gone (``elastic/torch_state.py``)."""
        for handle, _ in self._handles.values():
            ops._handles.discard(handle)
        for tree in self._window:
            for handle in tree.handles:
                ops._handles.discard(handle)
        self._handles.clear()
        self._window = []
        self._pass_queued = False
        self._counters = {n: 0 for n in self._counters}

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
                         postscale_factor: float = 1.0,
                         overlap: bool = False):
    """Wrap ``optimizer`` so that ``step()`` applies gradients allreduced
    across ranks with ``op`` (Average or Sum), or, with ``op=Adasum``, its
    own steps combined across ranks by Adasum (the JAX bridge's factory,
    ``horovod_tpu/frameworks/torch/__init__.py:468-491``).  ``overlap=True``
    reduces each of the ``backward_passes_per_step`` microbatches as one
    fused tree while the next one's backward runs (module docstring)."""
    if op == ops.Adasum:
        if backward_passes_per_step != 1:
            raise ValueError(
                "backward_passes_per_step > 1 is not supported with "
                "op=Adasum (the delta-space optimizer communicates whole "
                "optimizer steps; accumulate before calling step())")
        if overlap:
            raise ValueError("overlap=True is not supported with op=Adasum")
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "op=Adasum takes no prescale_factor or postscale_factor: "
                "the delta-space optimizer combines whole optimizer steps")
        return _DistributedAdasumOptimizer(optimizer, named_parameters,
                                           compression)
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if overlap and backward_passes_per_step < 2:
        raise ValueError(
            "overlap=True needs backward_passes_per_step >= 2 (there is no "
            "later microbatch to overlap with); for single-backward steps "
            "use make_overlapped_train_step, which overlaps comm with "
            "backward inside one compiled program")
    return _DistributedOptimizer(
        optimizer, named_parameters, compression, backward_passes_per_step,
        op, prescale_factor, postscale_factor, overlap)


def distributed_value_and_grad(fun, op: Optional[str] = None,
                               compression=Compression.none):
    """``wrapped(params, *args, **kwargs) -> (value, grads)``: ``value =
    fun(params, *args, **kwargs)`` for ``params`` a tree (list, tuple or
    dict) of tensors that require grad, and ``grads`` its gradients, in the
    tree's shape, reduced across ranks with ``op`` (default Average): one
    fused buffer per dtype, or, for Adasum, whose operator is per tensor,
    one named allreduce per leaf (``frameworks/jax/optimizer.py:127-178``).
    The counterpart of ``DistributedGradientTape``."""
    op = op or ops.Average

    def wrapped(params, *args, **kwargs):
        leaves, spec = pytree.tree_flatten(params)
        value = fun(params, *args, **kwargs)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = pytree.tree_unflatten(
            [g if g is not None else torch.zeros_like(l)
             for g, l in zip(grads, leaves)], spec)
        if ops.initialized():
            if op == ops.Adasum:
                grads = _allreduce_tree_per_leaf(grads, op, compression)
            else:
                grads = wfbp.wait_tree(wfbp.enqueue_tree_fused(
                    grads, op, compression))
        return value.detach(), grads

    return wrapped


def _allreduce_tree_per_leaf(grads, op, compression, name_prefix="grad"):
    """One named allreduce per leaf, all enqueued before one batched wait
    (``_allreduce_tree_per_leaf``)."""
    paths, spec = pytree.tree_flatten_with_path(grads)
    handles, ctxs = [], []
    for path, leaf in paths:
        comp, ctx = compression.compress(leaf)
        ctxs.append(ctx)
        handles.append(ops.allreduce_async(
            comp, name=f"{name_prefix}.{pytree.keystr(path)}", op=op))
    out = [compression.decompress(r, c)
           for r, c in zip(ops.synchronize_many(handles), ctxs)]
    return pytree.tree_unflatten(out, spec)
