"""Elastic (fault-tolerant, autoscaling) training: ``hvd.elastic``.

The port's copy of ``horovod_tpu/elastic`` with the torch state of
``horovod_tpu/frameworks/torch/elastic.py`` (reference: SURVEY §5.3).
Three cooperating parts:

- the worker side (:mod:`.state`, :mod:`.torch_state`): ``State`` objects
  with commit, restore and sync, and the ``@hvd.elastic.run`` wrapper that
  retries the training function across membership changes;
- the driver side (:mod:`.driver`, :mod:`.discovery`, :mod:`.registration`,
  :mod:`.launcher`), in the launcher's process: the discovery script
  polled every second, the host set's diff and blacklist, stable ranks,
  the workers' exits, leases and requests, and one membership epoch per
  change, published through the rendezvous server;
- the notification channel (:mod:`.worker`): signed driver -> worker
  pings.

Run a job with ``python -m horovod_tpu_torch.runner.launch -np N --min-np M
[--max-np K] --host-discovery-script S python train.py``.
"""

from ..common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .state import ObjectState, State, run
from .torch_state import ElasticSampler, TorchState

__all__ = ["State", "ObjectState", "TorchState", "ElasticSampler", "run",
           "HorovodInternalError", "HostsUpdatedInterrupt"]
