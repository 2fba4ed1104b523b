"""Hand-written CUDA kernels of the port and the modules built on them."""

from .conv_bn_stats import (
    FusedConv1x1BN,
    MatmulBNStats,
    SyncedMatmulBNStats,
    matmul_bn_stats,
    matmul_bn_stats_reference,
    synced_matmul_bn_stats,
)

__all__ = ["FusedConv1x1BN", "MatmulBNStats", "SyncedMatmulBNStats",
           "matmul_bn_stats", "matmul_bn_stats_reference",
           "synced_matmul_bn_stats"]
