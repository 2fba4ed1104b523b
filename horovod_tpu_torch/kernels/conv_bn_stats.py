"""Fused 1x1-conv + BatchNorm-statistics matmul, and the module built on it.

Counterpart of ``horovod_tpu/kernels/conv_bn_stats.py``.  A 1x1 convolution
is a matmul over ``[B*H*W, Cin] @ [Cin, Cout]``; BatchNorm then needs each
output channel's sum and sum of squares.  The kernel
(``csrc/matmul_bn_stats.cu``, CUDA C++ for sm_90a) takes both sums from its
fp32 accumulator while the output tile is still on chip, so the activation
is never read again for statistics.  It loads its tiles by TMA, multiplies
with ``wgmma`` and stores ``y`` by TMA, one persistent block per SM.

:func:`matmul_bn_stats` sends CUDA tensors to that kernel and CPU tensors to
:func:`matmul_bn_stats_reference`, its plain PyTorch version.  A CUDA tensor
the kernel does not take raises; nothing falls back.  The backward is the
JAX package's ``_bwd_rule`` in plain torch matmuls (the TPU port never had a
kernel there either).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import nn

from ..initializers import lecun_normal
from . import build

#: Number of times the CUDA kernel has been launched in this process.
LAUNCHES = 0
#: Rows per row block of the kernel's statistics partials (``BM`` in
#: ``csrc/matmul_bn_stats.cu``, checked against it when the library loads):
#: the wrapper sums ``ceil(M / BLOCK_M)`` partial rows per column.
BLOCK_M = 128


def block_n(n: int) -> int:
    """Columns per output tile at ``N``: 64 if that covers ``N``, else 128.
    A copy of ``block_n`` in the CUDA source, checked against it when the
    library loads."""
    return 64 if n <= 64 else 128


def matmul_bn_stats_reference(x: torch.Tensor, w: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version: ``y = x @ w`` accumulated in fp32, returned in
    ``x.dtype``, with per-column ``sum(y)`` and ``sum(y*y)`` in fp32 taken
    from the fp32 product."""
    y = x.float() @ w.float()
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.library("matmul_bn_stats")
    fn = lib.hvd_matmul_bn_stats_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hvd_matmul_bn_stats_block_m.argtypes = []
    lib.hvd_matmul_bn_stats_block_m.restype = ctypes.c_int
    lib.hvd_matmul_bn_stats_block_n.argtypes = [ctypes.c_int]
    lib.hvd_matmul_bn_stats_block_n.restype = ctypes.c_int
    lib.hvd_matmul_bn_stats_max_m.argtypes = []
    lib.hvd_matmul_bn_stats_max_m.restype = ctypes.c_longlong
    if lib.hvd_matmul_bn_stats_block_m() != BLOCK_M:
        raise RuntimeError(f"matmul_bn_stats: the CUDA source's row block is "
                           f"{lib.hvd_matmul_bn_stats_block_m()}, the "
                           f"wrapper's {BLOCK_M}")
    for n in (8, 64, 72, 128, 136, 200, 256, 2048):
        if lib.hvd_matmul_bn_stats_block_n(n) != block_n(n):
            raise RuntimeError(f"matmul_bn_stats: the CUDA source's tile at "
                               f"N={n} is {lib.hvd_matmul_bn_stats_block_n(n)} "
                               f"columns, the wrapper's {block_n(n)}")
    return fn, BLOCK_M, lib.hvd_matmul_bn_stats_max_m()


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"matmul_bn_stats: x on {x.device} and w on {w.device}; the "
            "kernel takes two tensors on one CUDA device (CPU tensors take "
            "the plain version)")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"matmul_bn_stats: the kernel takes bf16, got "
                        f"x {x.dtype}, w {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_bn_stats: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} are not [M,K] @ [K,N]")
    m, k = x.shape
    n = w.shape[1]
    if m < 1 or k < 1 or n < 1 or k % 8 or n % 8:
        raise ValueError(f"matmul_bn_stats: M={m}, K={k}, N={n}; the kernel "
                         "takes M, K, N >= 1 with K and N multiples of 8")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_bn_stats: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("matmul_bn_stats: x and w must be 16-byte aligned")


def _launch(x: torch.Tensor, w: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global LAUNCHES
    _check(x, w)
    fn, block_m, max_m = _kernel()
    m, k = x.shape
    n = w.shape[1]
    if m > max_m:
        raise ValueError(f"matmul_bn_stats: M={m} exceeds one launch's "
                         f"{max_m} rows")
    row_blocks = -(-m // block_m)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partials = torch.empty((2, row_blocks, n), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 partials[0].data_ptr(), partials[1].data_ptr(), m, k, n,
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul_bn_stats: kernel launch failed with "
                           f"cudaError {err}")
    LAUNCHES += 1
    s = partials.sum(1)
    return y, s[0], s[1]


def matmul_bn_stats(x: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y = x @ w`` plus per-channel ``(sum(y), sum(y*y))`` in one pass.

    ``x``: ``[M, K]``, ``w``: ``[K, N]``.  Returns ``(y [M,N] in x.dtype,
    s1 [N] fp32, s2 [N] fp32)``.  CPU tensors take the plain version; CUDA
    tensors the kernel (bf16 only), or this raises."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_bn_stats_reference(x, w)
    return _launch(x, w)


class MatmulBNStats(torch.autograd.Function):
    """:func:`matmul_bn_stats` with the JAX package's VJP (``_bwd_rule``):
    with ``r = dy + ds1 + 2·y·ds2`` (the statistics' cotangents broadcast
    over rows, formed in fp32 from the SAVED output ``y``), ``dx = r @ wᵀ``
    and ``dw = xᵀ @ r``."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = matmul_bn_stats(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, y = ctx.saved_tensors
        r = dy.float() + ds1.float()[None, :] \
            + 2.0 * y.float() * ds2.float()[None, :]
        dx = (r @ w.float().t()).to(x.dtype)
        dw = (x.float().t() @ r).to(w.dtype)
        return dx, dw


class FusedConv1x1BN(nn.Module):
    """``Conv(features, 1x1, strides, no bias)`` then BatchNorm, with the
    statistics pass fused into the matmul in train mode.  Eval mode uses the
    running statistics and a plain matmul: it needs no statistics.

    NHWC in, NHWC out.  fp32 parameters and statistics, ``dtype`` compute,
    one-pass variance, running statistics ``m·old + (1−m)·batch`` with the
    biased batch variance (like flax, unlike ``torch.nn.BatchNorm2d``).
    Parameter names follow the flax module: ``kernel`` is ``[Cin, Cout]``.
    """

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16, momentum: float = 0.9,
                 epsilon: float = 1e-5, zero_scale: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon
        self.kernel = nn.Parameter(lecun_normal((in_features, features),
                                                in_features, generator))
        self.scale = nn.Parameter(torch.zeros(features) if zero_scale
                                  else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.strides != 1:
            # A 1x1 kernel reads only the strided positions.
            x = x[:, ::self.strides, ::self.strides, :]
        batch, h, w, cin = x.shape
        xm = x.to(self.dtype).reshape(-1, cin).contiguous()
        count = xm.shape[0]
        kernel = self.kernel.to(self.dtype)
        if self.training:
            y, s1, s2 = MatmulBNStats.apply(xm, kernel)
            y = y.float()
            mean = s1 / count
            var = torch.clamp(s2 / count - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            y = xm.float() @ kernel.float()
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        out = (y - mean) * inv + self.bias
        return out.to(self.dtype).reshape(batch, h, w, -1)
