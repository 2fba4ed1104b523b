"""Gradient compression for the eager allreduce path.

Counterpart of ``horovod_tpu/frameworks/jax/compression.py`` (reference
``horovod/torch/compression.py:1-74``): a compressor casts a tensor before
the allreduce and casts the result back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class Compressor:
    @staticmethod
    def compress(tensor: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.dtype]]:
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx) -> torch.Tensor:
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _HalfCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype in (torch.float32, torch.float64):
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_HalfCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_HalfCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """Namespace mirroring ``hvd.Compression`` (reference API)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
