"""Command-line flags and YAML config → the ``HOROVOD_*`` environment.

Counterpart of ``horovod_tpu/runner/config_parser.py`` (the reference's
``runner/common/util/config_parser.py:1-202``): every runtime knob the port
honours has a flag, a config-file key and a variable; flags win over the
file, and both become variables exported to every worker.  A config-file
key of the JAX launcher whose feature the port lacks is refused before any
worker starts (:data:`UNSUPPORTED_KEYS`).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..common import env

_MB = 1024 * 1024


def _flag(v) -> str:
    return "1" if v else "0"


#: (args attribute, YAML key, variable, transform), the JAX rows of the
#: knobs this port acts on.
_PARAMS = [
    ("fusion_threshold_mb", "fusion-threshold-mb",
     env.HOROVOD_FUSION_THRESHOLD, lambda v: str(int(float(v) * _MB))),
    ("cycle_time_ms", "cycle-time-ms", env.HOROVOD_CYCLE_TIME, str),
    ("cache_capacity", "cache-capacity", env.HOROVOD_CACHE_CAPACITY, str),
    ("timeline_filename", "timeline-filename", env.HOROVOD_TIMELINE, str),
    ("timeline_mark_cycles", "timeline-mark-cycles",
     env.HOROVOD_TIMELINE_MARK_CYCLES, _flag),
    ("no_stall_check", "no-stall-check", env.HOROVOD_STALL_CHECK_DISABLE,
     _flag),
    ("stall_check_warning_time_seconds", "stall-check-warning-time-seconds",
     env.HOROVOD_STALL_CHECK_TIME_SECONDS, str),
    ("stall_check_shutdown_time_seconds", "stall-check-shutdown-time-seconds",
     env.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, str),
    ("log_level", "log-level", env.HOROVOD_LOG_LEVEL, str),
    ("data_plane", "data-plane", env.HOROVOD_DATA_PLANE, str),
]

_TUNING = "ROADMAP A7 (autotune)"

#: The JAX launcher's config-file keys whose feature the port lacks, with
#: the slice that brings it.
UNSUPPORTED_KEYS = {
    "autotune": _TUNING,
    "autotune-log-file": _TUNING,
    "autotune-warmup-samples": _TUNING,
    "autotune-steps-per-sample": _TUNING,
    "mesh-axes": "ROADMAP A8 (parallel/: the device mesh)",
}


def _unset(val) -> bool:
    # A 0 is a value (``--cache-capacity 0`` turns the cache off); the JAX
    # mapping's ``in (None, False, "")`` drops it, as 0 == False.
    return val is None or val is False or val == ""


def env_from_args(args) -> Dict[str, str]:
    """The ``HOROVOD_*`` variables of the parsed flags (a flag left unset,
    None or False is omitted, so the user's environment and the defaults
    still apply)."""
    out: Dict[str, str] = {}
    for attr, _, var, transform in _PARAMS:
        val = getattr(args, attr, None)
        if not _unset(val):
            out[var] = transform(val)
    return out


def apply_config_file(args, path: Optional[str]) -> None:
    """Overlay the YAML config onto the flags left unset (flags win,
    reference ``launch.py:293-296,513-517``).  A key of
    :data:`UNSUPPORTED_KEYS` raises ``ValueError`` naming its slice."""
    if not path:
        return
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError("--config-file requires pyyaml") from e
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    problems = [f"{key!r} needs {where}, which this port does not have yet"
                for key, where in UNSUPPORTED_KEYS.items() if key in cfg]
    if problems:
        raise ValueError(f"--config-file {path}: " + "; ".join(problems))
    for attr, key, _, _ in _PARAMS:
        if _unset(getattr(args, attr, None)) and key in cfg:
            setattr(args, attr, cfg[key])
