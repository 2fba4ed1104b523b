"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

``import horovod_tpu_torch as hvd`` gives the Horovod surface for torch:
``hvd.init()``, the eager allreduce ops, ``hvd.DistributedOptimizer`` and
``hvd.Compression``.  The runtime works on the card (``cuda:<local_rank>``)
unless ``hvd.init(device="cpu")`` asks for the CPU.  This package imports
neither JAX nor ``horovod_tpu``.
"""

from .basics import (
    cross_rank,
    cross_size,
    device,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from .common.exceptions import HorovodInternalError
from .compression import Compression
from .ops import (
    Adasum,
    Average,
    Sum,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    poll,
    synchronize,
)
from .optimizer import DistributedOptimizer

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device",
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "poll", "synchronize", "Sum", "Average", "Adasum",
    "Compression", "DistributedOptimizer", "HorovodInternalError",
]
