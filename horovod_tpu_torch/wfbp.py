"""Fusion at the source, and the whole training step as one program.

Counterpart of ``horovod_tpu/frameworks/jax/wfbp.py``, in torch idiom.

1. **The fused tree** (:func:`enqueue_tree_fused` / :func:`wait_tree`,
   used by ``DistributedOptimizer(overlap=True)`` and
   ``distributed_value_and_grad``): a tree of gradients (a list, tuple or
   dict of tensors, flattened with ``torch.utils._pytree``, torch's
   ``jax.tree_util``) goes to the runtime as one flat buffer per dtype
   under one negotiated name per dtype, ``{prefix}.fused.{dtype}.{numel}``
   with the dtype spelled as numpy spells it, so the same tree gets the
   same wire names in both packages.  The step blocks once per buffer
   (``ops.synchronize_many``), never once per tensor.

2. **The whole step as one program** (:func:`make_overlapped_train_step`):
   forward, backward, the gradients fused per dtype, their average across
   ranks, the unfuse into ``p.grad`` and ``optimizer.step()``.  The JAX
   package compiles this into one XLA program; on the card it is one
   captured CUDA graph, replayed per step, so no host code runs between
   the step's kernels and the runtime's negotiation is not on its path.
   At size > 1 the average is an allreduce inside the graph (the
   in-program collective, which bypasses negotiation as the JAX step's
   psum does), then a division by the size, on an NCCL group of the step's
   own, built on the launcher's store beside the runtime's groups, whose
   collectives the background loop issues at the same time
   (``HorovodGlobalState.own_group``).  On the CPU
   (``hvd.init(device="cpu")``) the same step runs uncaptured, its average
   on a gloo group of its own: the counterpart of the JAX package's XLA
   plane on CPU devices.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

from . import ops
from .common.env import HOROVOD_DATA_PLANE, PLANE_NCCL
from .common.exceptions import HorovodInternalError
from .compression import Compression
from .core.state import global_state
from .kernels import conv_bn_stats
from .kernels import flash_attention

# ---------------------------------------------------------------------------
# the fused tree
# ---------------------------------------------------------------------------

# One plan per (shapes, dtypes) signature: steady-state training reuses one
# entry for ever.
_plans: Dict[tuple, "FusePlan"] = {}
_plans_lock = threading.Lock()


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype as numpy spells it (``float32``, ``bfloat16``, ``int64``)."""
    return str(dtype).split(".")[-1]


def signature(leaves) -> tuple:
    """((shape, dtype name), ...) of a tree's leaves."""
    return tuple((tuple(l.shape), dtype_name(l.dtype)) for l in leaves)


class FusePlan(NamedTuple):
    """``groups``: (dtype name, leaf indices) in the order each dtype is
    first seen; ``flatten(leaves)``: one new flat buffer per group (always a
    copy, so the leaves may change while it is in flight);
    ``unflatten(bufs)``: per leaf, a view of its group's buffer in the
    leaf's shape, in the leaves' order."""
    groups: List[Tuple[str, List[int]]]
    flatten: Callable
    unflatten: Callable


def _fuse_plan(sig: tuple) -> FusePlan:
    with _plans_lock:
        cached = _plans.get(sig)
    if cached is not None:
        return cached
    by_dtype: Dict[str, List[int]] = {}
    for i, (_, dt) in enumerate(sig):
        by_dtype.setdefault(dt, []).append(i)
    groups = list(by_dtype.items())

    def flatten(leaves) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.cat([leaves[i].reshape(-1) for i in idxs])
                     for _, idxs in groups)

    def unflatten(bufs) -> List[torch.Tensor]:
        outs = [None] * len(sig)
        for buf, (_, idxs) in zip(bufs, groups):
            off = 0
            for i in idxs:
                shape = sig[i][0]
                n = 1
                for d in shape:
                    n *= d
                outs[i] = buf[off:off + n].view(shape)
                off += n
        return outs

    plan = FusePlan(groups, flatten, unflatten)
    with _plans_lock:
        _plans[sig] = plan
    return plan


class PendingTree(NamedTuple):
    """An in-flight fused-tree allreduce: what :func:`wait_tree` needs."""
    handles: tuple
    ctxs: tuple
    plan: FusePlan
    spec: Any
    compression: Any


def enqueue_tree_fused(grads, op, compression=Compression.none,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0,
                       name_prefix: str = "grad") -> PendingTree:
    """Enqueue a tree of tensors as one fused buffer per dtype and return
    at once; the runtime negotiates and reduces while the caller goes on.
    Finish with :func:`wait_tree`."""
    leaves, spec = pytree.tree_flatten(grads)
    plan = _fuse_plan(signature(leaves))
    handles, ctxs = [], []
    for buf, (dt, _) in zip(plan.flatten(leaves), plan.groups):
        comp, ctx = compression.compress(buf)
        ctxs.append(ctx)
        handles.append(ops.allreduce_async(
            comp, name=f"{name_prefix}.fused.{dt}.{buf.numel()}", op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor))
    return PendingTree(tuple(handles), tuple(ctxs), plan, spec, compression)


def wait_tree(pending: PendingTree):
    """The reduced tree of a :class:`PendingTree`, in its shape (each leaf
    a view of its dtype's reduced buffer), after one batched wait."""
    results = ops.synchronize_many(pending.handles)
    reduced = [pending.compression.decompress(r, c)
               for r, c in zip(results, pending.ctxs)]
    return pytree.tree_unflatten(pending.plan.unflatten(reduced),
                                 pending.spec)


# ---------------------------------------------------------------------------
# the whole step as one CUDA graph
# ---------------------------------------------------------------------------


# Names the step groups: every rank builds its steps in the same order.
_step_ids = itertools.count()


def _launch_counts() -> Dict[str, int]:
    return {"matmul_bn_stats": conv_bn_stats.LAUNCHES,
            **flash_attention.LAUNCHES}


class OverlappedTrainStep:
    """Forward, backward, the gradients' average across ranks and
    ``optimizer.step()`` as one replayed CUDA graph.

    Usage (one process per card, ``hvd.init()`` called, a plain optimizer,
    not a ``DistributedOptimizer``)::

        step = hvd.make_overlapped_train_step(model, loss_fn, optimizer)
        for batch in data:                 # this rank's shard
            loss = step(batch)             # a device tensor

    ``loss_fn(model, batch) -> scalar`` reduces with a mean over the batch
    it is given.  The JAX step's pieces map so: its ``params`` and
    ``opt_state`` are the model's parameters and the optimizer's state,
    updated in place, so ``init``, ``fetch`` and ``donate`` have no
    counterpart; its ``has_aux`` state (flax ``batch_stats``) is the
    model's buffers, which BatchNorm updates in place inside the graph.

    On the card the first call runs one eager step on a side stream (it
    builds the kernels, sets their attributes and creates the optimizer's
    state: nothing of that may happen during capture), then captures the
    step into a ``torch.cuda.CUDAGraph`` with the batch's tensors copied
    into static inputs; every later call copies the batch into them and
    replays.  A failed capture raises: there is no fallback.  Optimizers
    that have a ``capturable`` flag (AdamW) must set it.  The kernel
    wrappers count their launches once, at capture: :meth:`launches`
    gives the captured counts times the replays.  Every parameter that
    requires grad gets the averaged gradient, zeros where no rank had one.

    Before the first step at size > 1 the ranks check through an object
    allgather that they hold the same parameter and batch shapes.  A model
    with a BatchNorm synced across ranks (``ResNet(sync_bn=True)``,
    ``hvd.SyncBatchNorm``) is refused at size > 1: its statistics'
    allreduces go through the runtime, which no graph can hold.  The
    returned loss is this rank's, of its last step.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer,
                 check_signatures: bool = True):
        self._model = model
        self._loss_fn = loss_fn
        self._opt = optimizer
        self._check_signatures = check_signatures
        self._params = [p for p in model.parameters() if p.requires_grad]
        # BatchNorms synced across ranks, which a graph cannot hold at
        # size > 1.
        self._synced = [name for name, m in model.named_modules()
                        if getattr(m, "sync_name", None) is not None]
        self._sig_checked = False
        self._group = None
        self._graph = None
        self._static: List[torch.Tensor] = []
        self._batch_spec = None
        self._static_loss = None
        # The runtime the step's group and graph belong to: an elastic
        # reset tears it down.
        self._runtime = None
        #: Replays so far, and the kernels' launches recorded at capture.
        self.replays = 0
        self.captured_launches: Dict[str, int] = {}

    def _context(self):
        state = global_state()
        if self._runtime is not None and state is not self._runtime:
            raise HorovodInternalError(
                "make_overlapped_train_step: this step's process group and "
                "CUDA graph belong to a runtime that was torn down (an "
                "elastic reset, or hvd.shutdown()); build a new step for "
                "the new world")
        state._check_initialized()
        if self._synced and state.topo.size > 1:
            raise RuntimeError(
                f"make_overlapped_train_step cannot capture the runtime's "
                f"allreduces of a BatchNorm synced across ranks: layer "
                f"{self._synced[0]!r} ({len(self._synced)} synced layers in "
                f"all).  "
                f"Build the model without synced BatchNorm (sync_bn=False), "
                f"or train it through DistributedOptimizer.")
        if state.device.type == "cuda" and state.topo.size > 1 \
                and state.plane != PLANE_NCCL:
            raise RuntimeError(
                "make_overlapped_train_step needs the device plane at size "
                f"> 1 ({HOROVOD_DATA_PLANE}={PLANE_NCCL}, one card per "
                "rank): its average runs on the runtime's NCCL group inside "
                "the CUDA graph.  On the host plane use "
                "DistributedOptimizer(overlap=True) with "
                "backward_passes_per_step>=2 instead.")
        return state

    def _signature(self, leaves) -> str:
        return repr((list(signature(self._params)), list(signature(leaves))))

    def _check(self, leaves) -> None:
        from .functions import allgather_object

        sig = self._signature(leaves)
        sigs = allgather_object(sig, name="wfbp.step.signature")
        if any(s != sig for s in sigs):
            raise RuntimeError(
                "overlapped train step diverged across ranks: this rank "
                f"traced {sig}; world traced {sigs}")
        self._sig_checked = True

    def _average(self, state) -> None:
        """The gradients fused per dtype, averaged across ranks, unfused
        into ``p.grad``."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        plan = _fuse_plan(signature(grads))
        bufs = plan.flatten(grads)
        size = state.topo.size
        if size > 1:
            for buf in bufs:
                self._group.allreduce([buf]).wait()
                buf.div_(size)
        with torch.no_grad():
            for p, g in zip(self._params, plan.unflatten(bufs)):
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)

    def _body(self, state, batch) -> torch.Tensor:
        loss = self._loss_fn(self._model, batch)
        loss.backward()
        self._average(state)
        self._opt.step()
        return loss.detach()

    def _check_capturable(self) -> None:
        for group in self._opt.param_groups:
            if "capturable" in group and not group["capturable"]:
                raise ValueError(
                    f"{type(self._opt).__name__} runs inside a CUDA graph "
                    "only when built with capturable=True")

    def _capture(self, state, leaves) -> torch.Tensor:
        self._check_capturable()
        dev = state.device
        self._static = [leaf.detach().to(dev, copy=True) for leaf in leaves]
        batch = pytree.tree_unflatten(self._static, self._batch_spec)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._opt.zero_grad(set_to_none=True)
            loss = self._body(state, batch)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _launch_counts()
        self._opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_loss = self._body(state, batch)
        after = _launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self._graph = graph
        return loss

    def launches(self) -> Dict[str, int]:
        """Kernel launches the replays made: captured counts × replays."""
        return {k: n * self.replays for k, n in self.captured_launches.items()}

    def __call__(self, batch) -> torch.Tensor:
        """One training step on this rank's ``batch`` (a tensor or a tree
        of tensors); returns its loss, a device tensor."""
        state = self._context()
        leaves, spec = pytree.tree_flatten(batch)
        if self._check_signatures and not self._sig_checked \
                and state.topo.size > 1:
            self._check(leaves)
        if self._group is None and state.topo.size > 1:
            self._group = state.own_group(f"wfbp.step{next(_step_ids)}")
            self._runtime = state
        if state.device.type != "cuda":
            self._opt.zero_grad(set_to_none=True)
            return self._body(state, batch)
        if self._graph is None:
            self._batch_spec = spec
            self._runtime = state
            return self._capture(state, leaves)
        if spec != self._batch_spec or any(
                l.shape != s.shape or l.dtype != s.dtype
                for l, s in zip(leaves, self._static)):
            raise ValueError(
                "the batch's structure, shapes or dtypes differ from the "
                "captured step's; build a new step for a new batch shape")
        for static, leaf in zip(self._static, leaves):
            static.copy_(leaf)
        self._graph.replay()
        self.replays += 1
        return self._static_loss.clone()


def make_overlapped_train_step(model: torch.nn.Module, loss_fn: Callable,
                               optimizer: torch.optim.Optimizer, *,
                               check_signatures: bool = True
                               ) -> OverlappedTrainStep:
    """:class:`OverlappedTrainStep` (see its docstring)."""
    return OverlappedTrainStep(model, loss_fn, optimizer,
                               check_signatures=check_signatures)
