"""ResNet v1.5 in PyTorch, laid out like ``horovod_tpu/models/resnet.py``.

NHWC inputs ``[batch, H, W, 3]`` → logits ``[batch, num_classes]``;
activations stay NHWC (channels_last) inside.  fp32 parameters, ``dtype``
compute (bf16 on the card), fp32 one-pass BatchNorm statistics.  Submodules
carry flax's auto-names (``BottleneckBlock_0``, ``Conv_0``, ``BatchNorm_0``,
``FusedConv1x1BN_0``, ``conv_init``, ``Dense_0`` ...) so that
:func:`horovod_tpu_torch.convert.from_flax` maps parameters one to one.

Where torch's defaults differ from flax's, this module does what flax does:
``padding='SAME'`` on a stride-2 3x3 pads (0 before, 1 after) on even inputs,
and BatchNorm keeps the biased running variance with ``m·old + (1−m)·batch``.

``ResNet(sync_bn=True)`` normalizes every BatchNorm over every rank's batch,
as the JAX model does under its sharded step (GSPMD for the plain
BatchNorms, ``fused_bn_mesh`` for the fused ones): each fused layer through
``synced_matmul_bn_stats``, each plain one through one Sum allreduce of its
fp32 ``[sum; sumsq; count]`` forward and of their two cotangents backward.
Each layer's allreduces are named ``sync_bn.<its module path>``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..initializers import lecun_normal
from ..kernels.conv_bn_stats import FusedConv1x1BN, sync_layer_name
from ..ops import size_or_one
from ..sync_batch_norm import SumAcrossRanks

_BN_MOMENTUM = 0.9
_BN_EPSILON = 1e-5


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's ``'SAME'``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False)`` on NHWC; ``kernel`` is OIHW."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, padding: Union[str, int] = "SAME",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.strides = strides
        self.padding = padding
        self.dtype = dtype
        fan_in = in_features * kernel_size * kernel_size
        self.kernel = nn.Parameter(lecun_normal(
            (features, in_features, kernel_size, kernel_size), fan_in,
            generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding == "SAME":
            ph = _same_pads(x.shape[1], self.kernel_size, self.strides)
            pw = _same_pads(x.shape[2], self.kernel_size, self.strides)
        else:
            ph = pw = (self.padding, self.padding)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            # Asymmetric: pad the NHWC tensor itself (stays channels_last).
            x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
            pad = (0, 0)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(self.dtype),
                     stride=self.strides, padding=pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` with ``force_float32_reductions`` and
    ``use_fast_variance`` on NHWC: fp32 one-pass statistics, running
    statistics ``m·old + (1−m)·batch`` with the biased variance, output
    normalized in fp32 and cast to ``dtype``.  ``sync=True``: statistics
    over every rank's batch (:class:`SumAcrossRanks`, named after
    ``sync_name``); at size 1 the same bits as ``sync=False``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 momentum: float = _BN_MOMENTUM, epsilon: float = _BN_EPSILON,
                 zero_scale: bool = False, sync: bool = False):
        super().__init__()
        self.sync_name = sync_layer_name() if sync else None
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.zeros(features) if zero_scale
                                  else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if self.sync_name is not None and size_or_one() > 1:
                flat = xf.reshape(-1, xf.shape[-1])
                c = flat.shape[1]
                stats = SumAcrossRanks.apply(torch.cat([
                    flat.sum(0), (flat * flat).sum(0),
                    flat.new_tensor([float(flat.shape[0])])]),
                    self.sync_name, 2 * c)
                count = stats[2 * c].detach()
                mean = stats[:c] / count
                var = torch.clamp(stats[c:2 * c] / count - mean * mean,
                                  min=0.0)
            else:
                dims = tuple(range(x.dim() - 1))
                mean = xf.mean(dims)
                var = torch.clamp((xf * xf).mean(dims) - mean * mean,
                                  min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * inv + self.bias).to(self.dtype)


class Dense(nn.Module):
    """``flax.linen.Dense`` in fp32; ``kernel`` is ``[out, in]``."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(
            lecun_normal((in_features, features), in_features, generator).t()
            .contiguous())
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.kernel, self.bias)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 sync_bn: bool = False):
        super().__init__()
        self.fused = fused
        out = filters * 4
        self.has_proj = in_features != out or strides != 1
        norm = functools.partial(BatchNorm, dtype=dtype, sync=sync_bn)
        if fused:
            # Every conv(1x1)+BN pair runs the fused-statistics kernel; the
            # 3x3 stays a library convolution.
            fcb = functools.partial(FusedConv1x1BN, dtype=dtype,
                                    momentum=_BN_MOMENTUM,
                                    epsilon=_BN_EPSILON, generator=generator,
                                    sync=sync_bn)
            self.FusedConv1x1BN_0 = fcb(in_features, filters)
            self.Conv_0 = Conv(filters, filters, 3, strides, dtype=dtype,
                               generator=generator)
            self.BatchNorm_0 = norm(filters)
            self.FusedConv1x1BN_1 = fcb(filters, out, zero_scale=True)
            if self.has_proj:
                self.fused_proj = fcb(in_features, out, strides=strides)
        else:
            self.Conv_0 = Conv(in_features, filters, 1, dtype=dtype,
                               generator=generator)
            self.BatchNorm_0 = norm(filters)
            self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype,
                               generator=generator)
            self.BatchNorm_1 = norm(filters)
            self.Conv_2 = Conv(filters, out, 1, dtype=dtype,
                               generator=generator)
            self.BatchNorm_2 = norm(out, zero_scale=True)
            if self.has_proj:
                self.conv_proj = Conv(in_features, out, 1, strides,
                                      dtype=dtype, generator=generator)
                self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.fused:
            y = F.relu(self.FusedConv1x1BN_0(x))
            y = F.relu(self.BatchNorm_0(self.Conv_0(y)))
            y = self.FusedConv1x1BN_1(y)
            if self.has_proj:
                residual = self.fused_proj(residual)
        else:
            y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
            y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
            y = self.BatchNorm_2(self.Conv_2(y))
            if self.has_proj:
                residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 sync_bn: bool = False):
        super().__init__()
        norm = functools.partial(BatchNorm, dtype=dtype, sync=sync_bn)
        self.has_proj = in_features != filters or strides != 1
        self.Conv_0 = Conv(in_features, filters, 3, strides, dtype=dtype,
                           generator=generator)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype,
                           generator=generator)
        self.BatchNorm_1 = norm(filters, zero_scale=True)
        if self.has_proj:
            self.conv_proj = Conv(in_features, filters, 1, strides,
                                  dtype=dtype, generator=generator)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.has_proj:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NHWC inputs ``[batch, H, W, 3]`` → logits ``[batch, num_classes]``.
    Train/eval mode (``.train()``/``.eval()``) picks batch or running
    statistics, as flax's ``train`` argument does.  ``sync_bn=True``:
    every BatchNorm over every rank's batch (the module's docstring)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 fuse_conv1x1_bn: bool = False,
                 generator: Optional[torch.Generator] = None,
                 sync_bn: bool = False):
        super().__init__()
        if fuse_conv1x1_bn and block_cls is not BottleneckBlock:
            # Silently building unfused would let a run labelled "fused"
            # measure the baseline.
            raise ValueError(
                "fuse_conv1x1_bn=True is only implemented for "
                f"BottleneckBlock (got {block_cls!r})")
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype,
                              generator=generator)
        self.bn_init = BatchNorm(num_filters, dtype, sync=sync_bn)
        kwargs = {"fused": True} if fuse_conv1x1_bn else {}
        expansion = 4 if block_cls is BottleneckBlock else 1
        in_features = num_filters
        index = 0
        for i, block_count in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(block_count):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"{block_cls.__name__}_{index}", block_cls(
                    in_features, filters, strides, dtype=dtype,
                    generator=generator, sync_bn=sync_bn, **kwargs))
                in_features = filters * expansion
                index += 1
        self.num_blocks = index
        self.block_name = block_cls.__name__
        self.Dense_0 = Dense(in_features, num_classes, generator=generator)
        for name, module in self.named_modules():
            if getattr(module, "sync_name", None) is not None:
                module.sync_name = f"sync_bn.{name}"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        for index in range(self.num_blocks):
            x = getattr(self, f"{self.block_name}_{index}")(x)
        # The mean accumulates in fp32 and returns in the model dtype, as
        # jnp.mean does for bf16.
        x = x.float().mean(dim=(1, 2)).to(self.dtype)
        return self.Dense_0(x)


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
