"""Environment-variable knobs this package reads.

Same names and defaults as ``horovod_tpu/common/env.py`` (the reference's
``HOROVOD_*`` variables, ``horovod/common/common.h:64-91``), limited to what
the one-process runtime uses.
"""

from __future__ import annotations

import os

# -- topology (set by a launcher) --
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"

# -- runtime --
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"  # bytes
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"  # float ms
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"

# -- logging --
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIMESTAMP = "HOROVOD_LOG_HIDE_TIMESTAMP"

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_STALL_CHECK_TIME_SECONDS = 60
DEFAULT_STALL_SHUTDOWN_TIME_SECONDS = 0  # disabled


def get_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or val == "":
        return default
    return int(val)


def get_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None or val == "":
        return default
    return float(val)


def get_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None or val == "":
        return default
    return val.lower() not in ("0", "false", "no", "off", "")


def get_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)
