"""Hand-written CUDA kernels of the port and the modules built on them."""

from .conv_bn_stats import (
    FusedConv1x1BN,
    MatmulBNStats,
    matmul_bn_stats,
    matmul_bn_stats_reference,
)

__all__ = ["FusedConv1x1BN", "MatmulBNStats", "matmul_bn_stats",
           "matmul_bn_stats_reference"]
