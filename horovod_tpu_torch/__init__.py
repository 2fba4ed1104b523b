"""horovod_tpu_torch: the PyTorch/CUDA port of ``horovod_tpu``.

``import horovod_tpu_torch as hvd`` gives the Horovod surface for torch:
``hvd.init()``, the eager collectives (allreduce, broadcast, allgather,
alltoall, join, barrier, ``synchronize_many``),
``hvd.DistributedOptimizer`` (with ``overlap=True``),
``hvd.distributed_value_and_grad``, ``hvd.make_overlapped_train_step``
(the whole step as one CUDA graph; ``hvd.wfbp``), ``hvd.Compression``, and
the start-up broadcasts of parameters, optimizer state and objects, and
``hvd.start_timeline``/``stop_timeline`` (per-rank Chrome traces; the
tools in ``horovod_tpu_torch.tools`` merge and read them),
``hvd.SyncBatchNorm`` and ``hvd.checkpoint`` (rank 0's atomic snapshots
with a CRC manifest, ``save_rotating``/``restore_latest``).
``HOROVOD_FAULT_SPEC`` injects faults at the runtime's sites
(``common/faults.py``).  ``hvd.elastic`` (``State``, ``ObjectState``,
``TorchState``, ``ElasticSampler``, ``run``) trains through hosts that
leave, join or die, under the launcher's ``--min-np`` /
``--host-discovery-script``.  The runtime
works on the card (``cuda:<local_rank>``) unless
``hvd.init(device="cpu")`` asks for the CPU.  This package imports
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
    start_timeline,
    stop_timeline,
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
from . import checkpoint, elastic, wfbp
from .optimizer import DistributedOptimizer, distributed_value_and_grad
from .sync_batch_norm import SyncBatchNorm
from .wfbp import make_overlapped_train_step

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device",
    "size_or_one", "initialized", "start_timeline", "stop_timeline",
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_async",
    "broadcast_", "broadcast_async_", "alltoall", "join", "barrier",
    "poll", "synchronize", "synchronize_many",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "allgather_object",
    "Sum", "Average", "Adasum",
    "Compression", "DistributedOptimizer", "HorovodInternalError",
    "distributed_value_and_grad", "make_overlapped_train_step", "wfbp",
    "SyncBatchNorm", "checkpoint", "elastic",
]
