"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

``import horovod_tpu_torch as hvd`` gives the Horovod surface for torch:
``hvd.init()``, the eager collectives (allreduce, broadcast, allgather,
alltoall, join, barrier, ``synchronize_many``),
``hvd.DistributedOptimizer`` (with ``overlap=True``),
``hvd.distributed_value_and_grad``, ``hvd.make_overlapped_train_step``
(the whole step as one CUDA graph; ``hvd.wfbp``), ``hvd.Compression``, and
the start-up broadcasts of parameters, optimizer state and objects.  The runtime works on the card (``cuda:<local_rank>``)
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
from .functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .ops import (
    Adasum,
    Average,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    initialized,
    join,
    poll,
    size_or_one,
    synchronize,
    synchronize_many,
)
from . import wfbp
from .optimizer import DistributedOptimizer, distributed_value_and_grad
from .wfbp import make_overlapped_train_step

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device",
    "size_or_one", "initialized",
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_async",
    "broadcast_", "broadcast_async_", "alltoall", "join", "barrier",
    "poll", "synchronize", "synchronize_many",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "allgather_object",
    "Sum", "Average", "Adasum",
    "Compression", "DistributedOptimizer", "HorovodInternalError",
    "distributed_value_and_grad", "make_overlapped_train_step", "wfbp",
]
