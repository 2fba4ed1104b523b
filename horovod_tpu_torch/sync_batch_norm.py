"""Batch normalization over every rank's batch.

Counterpart of ``horovod_tpu/frameworks/torch/sync_batch_norm.py`` (the
reference's ``horovod/torch/sync_batch_norm.py:39-199``), exported as
``hvd.SyncBatchNorm``: the forward allreduces each channel's sum, sum of
squares and count, the backward allreduces its two per-channel
reductions, so that small per-rank batches normalize as one big batch.
NCHW (any ``[N, C, *]``), any device, torch's conventions: the running
variance is unbiased and ``momentum`` weighs the new batch.  The weight
and bias gradients stay local sums: ``DistributedOptimizer`` averages
them with every other gradient.

Each instance names its allreduces after itself (``sync_bn.<k>.fwd.stats``
and ``.bwd.stats``, ``k`` its place in this process's order of
construction), so that layers of different widths do not churn the
response cache under one name.

:class:`SumAcrossRanks` is the autograd op that the ResNet's flax-style
``BatchNorm(sync=True)`` (``models/resnet.py``) runs its statistics
through.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import Function
from torch.nn.modules.batchnorm import _BatchNorm

from . import ops
from .kernels.conv_bn_stats import sync_layer_name


class SumAcrossRanks(Function):
    """``stats`` summed over the ranks: a Sum allreduce named
    ``<name>.fwd``.  Its transpose is a Sum too: the backward allreduces
    the gradient of the first ``n_grad`` entries (``<name>.bwd``); the
    rest (the counts) get none."""

    @staticmethod
    def forward(ctx, stats, name, n_grad):
        ctx.name = name
        ctx.n_grad = n_grad
        return ops.allreduce(stats, op=ops.Sum, name=f"{name}.fwd")

    @staticmethod
    def backward(ctx, grad):
        summed = ops.allreduce(grad[:ctx.n_grad].contiguous(), op=ops.Sum,
                               name=f"{ctx.name}.bwd")
        return torch.cat([summed, grad.new_zeros(
            grad.shape[0] - ctx.n_grad)]), None, None


def _channel_view(t: torch.Tensor) -> torch.Tensor:
    """[N, C, *] → [C, N*prod(*)] so per-channel reductions are dim-1."""
    return t.transpose(0, 1).reshape(t.shape[1], -1)


class _SyncBatchNormFn(Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, name):
        flat = _channel_view(x)
        local_count = flat.shape[1]
        stats = torch.stack([
            flat.sum(dim=1),
            (flat * flat).sum(dim=1),
            torch.full((flat.shape[0],), float(local_count),
                       dtype=flat.dtype, device=flat.device),
        ])
        if ops.size_or_one() > 1:
            stats = ops.allreduce(stats, op=ops.Sum,
                                  name=f"{name}.fwd.stats")
        total_sum, total_sqsum, total_count = stats
        count = total_count[0].item()
        mean = total_sum / count
        var = total_sqsum / count - mean * mean
        invstd = torch.rsqrt(var + eps)

        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        out = xhat * weight.view(shape) + bias.view(shape)

        ctx.save_for_backward(xhat, weight, invstd)
        ctx.count = count
        ctx.name = name
        count = torch.tensor(count)
        ctx.mark_non_differentiable(mean, var, count)
        return out, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        xhat, weight, invstd = ctx.saved_tensors
        shape = [1, -1] + [1] * (dy.dim() - 2)

        dy_flat = _channel_view(dy)
        xhat_flat = _channel_view(xhat)
        # Local per-channel reductions; dx needs the global ones.
        g_dy = dy_flat.sum(dim=1)
        g_dy_xhat = (dy_flat * xhat_flat).sum(dim=1)
        if ops.size_or_one() > 1:
            sum_dy, sum_dy_xhat = ops.allreduce(
                torch.stack([g_dy, g_dy_xhat]), op=ops.Sum,
                name=f"{ctx.name}.bwd.stats")
        else:
            sum_dy, sum_dy_xhat = g_dy, g_dy_xhat

        n = ctx.count
        dx = (weight * invstd).view(shape) * (
            dy - (sum_dy.view(shape) + xhat * sum_dy_xhat.view(shape)) / n)
        # The weight and bias gradients are local sums.
        return dx, g_dy_xhat, g_dy, None, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in ``nn.BatchNorm{1,2,3}d`` with statistics over every rank's
    batch (reference ``torch/sync_batch_norm.py:39-97``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        #: The stem of this layer's allreduce names.
        self.sync_name = sync_layer_name()

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(input)

        if self.training and self.track_running_stats and \
                self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)

        use_batch_stats = self.training or not self.track_running_stats
        if not use_batch_stats:
            return F.batch_norm(
                input, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)

        weight = self.weight if self.weight is not None else \
            torch.ones(input.shape[1], dtype=input.dtype, device=input.device)
        bias = self.bias if self.bias is not None else \
            torch.zeros(input.shape[1], dtype=input.dtype,
                        device=input.device)
        out, mean, var, count = _SyncBatchNormFn.apply(
            input, weight, bias, self.eps, self.sync_name)

        if self.training and self.track_running_stats:
            m = self.momentum if self.momentum is not None else \
                1.0 / float(self.num_batches_tracked)
            n = float(count)  # the global element count per channel
            unbiased = var.detach() * n / max(n - 1.0, 1.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        return out


__all__ = ["SumAcrossRanks", "SyncBatchNorm"]
