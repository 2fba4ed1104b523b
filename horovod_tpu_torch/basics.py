"""Lifecycle + topology queries.

Counterpart of ``horovod_tpu/frameworks/jax/basics.py`` (the reference's
``horovod/common/basics.py:25-258``).  The runtime works on the card unless
the caller asks for the CPU: ``init(device=None)`` means
``cuda:<local_rank>`` and raises where CUDA is absent.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .common import env as env_mod
from .common.exceptions import HorovodInternalError
from .common.logging_util import get_logger
from .common.topology import ProcessTopology, from_env
from .core.state import global_state, reset_global_state

log = get_logger("horovod_tpu_torch.basics")

#: The device the first ``init()`` resolved: an elastic re-init brings the
#: runtime back on it (``elastic/state.py``).
_init_device: Optional[torch.device] = None


def _resolve_device(device: Union[None, str, torch.device],
                    topo: ProcessTopology) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise HorovodInternalError(
                "hvd.init(): CUDA is not available; pass device='cpu' to run "
                "the runtime on the CPU")
        return torch.device("cuda", topo.local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodInternalError(
                f"hvd.init(device={str(device)!r}): CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", topo.local_rank)
    elif device.type != "cpu":
        raise HorovodInternalError(
            f"hvd.init(): unsupported device {str(device)!r}; expected cuda "
            "or cpu")
    return device


def init(device: Union[None, str, torch.device] = None,
         topology: Optional[ProcessTopology] = None) -> None:
    """Initialize the runtime (``hvd.init()`` → ``horovod_init``,
    ``operations.cc:752``): topology from the launcher's environment (or
    given), background thread up, and at size > 1 the process groups
    joined.  ``device`` defaults to ``cuda:<local_rank>``; an explicit one
    is honoured, which is how several ranks share one card
    (``device="cuda:0"``).  A knob of the JAX runtime whose feature the
    port lacks raises ``ValueError`` (``common/env.py::check_knobs``)."""
    state = global_state()
    if state.initialized.is_set():
        return
    tuning = env_mod.check_knobs()
    if tuning:
        log.warning("ignoring %s: tuning knobs of the JAX runtime's own "
                    "machinery, which this port does not have",
                    ", ".join(f"{n}={env_mod.get_str(n)!r}" for n in tuning))
    global _init_device
    topo = topology or from_env()
    resolved = _resolve_device(device, topo)
    state.initialize(resolved, topology=topo)
    if _init_device is None:
        _init_device = resolved


def init_device() -> Optional[torch.device]:
    """The device the first ``init()`` of this process was given."""
    return _init_device


def shutdown() -> None:
    """Stop the runtime; a later ``init()`` starts a fresh one."""
    reset_global_state()


def _internal_reset() -> None:
    """The elastic reset's teardown: end the runtime without negotiating
    with a peer that may be dead or gone, and replace it by a fresh one
    (``horovod_tpu/frameworks/jax/basics.py:262``)."""
    reset_global_state(graceful=False)


def is_initialized() -> bool:
    """True while the runtime runs: False before ``init()``, after
    ``shutdown()``, and once a peer's loss (or an abort) has ended it."""
    return global_state().is_running()


def _topo() -> ProcessTopology:
    state = global_state()
    if not state.initialized.is_set() or state.topo is None:
        raise HorovodInternalError(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first.")
    return state.topo


def rank() -> int:
    return _topo().rank


def size() -> int:
    return _topo().size


def local_rank() -> int:
    return _topo().local_rank


def local_size() -> int:
    return _topo().local_size


def cross_rank() -> int:
    return _topo().cross_rank


def cross_size() -> int:
    return _topo().cross_size


def is_homogeneous() -> bool:
    return _topo().is_homogeneous


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Start a timeline at run time (reference ``operations.cc:780-806``),
    as ``HOROVOD_TIMELINE`` does at init: every rank writes its own trace
    (``pid = rank``; rank 0 at ``file_path``, rank r at
    ``file_path.rank<r>``), the negotiation lanes on rank 0's.  A running
    timeline is closed first.  Merge the files with
    ``python -m horovod_tpu_torch.tools.trace_merge`` and read them with
    ``python -m horovod_tpu_torch.tools.critical_path``."""
    global_state().start_timeline(file_path, mark_cycles)


def stop_timeline() -> None:
    """Close this rank's trace; nothing when none is running."""
    global_state().stop_timeline()


def device() -> torch.device:
    """The device this rank's runtime works on."""
    _topo()
    return global_state().device
