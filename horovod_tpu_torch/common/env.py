"""Environment-variable knobs this package reads.

Same names and defaults as ``horovod_tpu/common/env.py`` (the reference's
``HOROVOD_*`` variables, ``horovod/common/common.h:64-91``), limited to what
the port's runtime uses.
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

# -- rendezvous / control plane (set by the launcher) --
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
# Bring-up budget in seconds: store connection, the control group's
# rendezvous, and the timeout of every collective on the groups.
HOROVOD_MESH_STARTUP_TIMEOUT = "HOROVOD_MESH_STARTUP_TIMEOUT"

# -- runtime --
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"  # bytes
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"  # float ms
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
# Response cache entries at the coordinator (LRU); 0 turns the cache and
# its mask fast path off.  The cache runs only at size > 1.
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
# Order of a cycle's responses before fusion: "readiness" (default: by
# first request, oldest first) or "arrival" (completion order).  The mask
# fast path keeps its ascending-bit order either way.
HOROVOD_FUSION_ORDER = "HOROVOD_FUSION_ORDER"
# Straggler detector (coordinator): a rank whose readiness-lag EWMA (how
# long it keeps tensors waiting after the median announcer) exceeds this
# many seconds is flagged; 0 turns flagging off, the EWMAs still update.
HOROVOD_STRAGGLER_THRESHOLD_SECS = "HOROVOD_STRAGGLER_THRESHOLD_SECS"
# The EWMA's smoothing factor, in (0, 1].
HOROVOD_STRAGGLER_EWMA_ALPHA = "HOROVOD_STRAGGLER_EWMA_ALPHA"
# A rank whose EWMA stays above this many seconds for
# HOROVOD_STRAGGLER_DEMOTE_CYCLES consecutive busy cycles gets a demotion
# verdict (a log line and a flight-recorder event: there is no elastic
# driver to act on it).  0, the default, turns demotion off.
HOROVOD_STRAGGLER_DEMOTE_SECS = "HOROVOD_STRAGGLER_DEMOTE_SECS"
HOROVOD_STRAGGLER_DEMOTE_CYCLES = "HOROVOD_STRAGGLER_DEMOTE_CYCLES"
# Where the cross-rank allreduce runs at size > 1: "cpu" (or "tcp", the JAX
# package's name for it), the default, sums on the host over the gloo
# control group; "nccl", the counterpart of the JAX package's "xla", sums
# on the card over an NCCL group.
HOROVOD_DATA_PLANE = "HOROVOD_DATA_PLANE"

# -- flight recorder: a ring of recent events, dumped to
# <dir>/hvd_flight_recorder/hvd_flight_recorder.rank<N>.json when the
# background loop dies ("1"/"0", default on; dir default the cwd) --
HOROVOD_FLIGHT_RECORDER = "HOROVOD_FLIGHT_RECORDER"
HOROVOD_FLIGHT_RECORDER_DIR = "HOROVOD_FLIGHT_RECORDER_DIR"
HOROVOD_FLIGHT_RECORDER_EVENTS = "HOROVOD_FLIGHT_RECORDER_EVENTS"

# -- logging --
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIMESTAMP = "HOROVOD_LOG_HIDE_TIMESTAMP"

# -- knobs of the JAX runtime that this port does not act on.  A job that
# sets one of the first group gets an error at ``hvd.init()`` naming the
# slice that brings its feature (ROADMAP.md A2, A6, A7, A9), instead of a
# run without it; the second group only tunes machinery the port does not
# have, and gets one warning. --
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_TIMELINE_LIFECYCLE = "HOROVOD_TIMELINE_LIFECYCLE"
HOROVOD_TIMELINE_CONTROL_PLANE = "HOROVOD_TIMELINE_CONTROL_PLANE"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_CODEC = "HOROVOD_AUTOTUNE_CODEC"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_METRICS = "HOROVOD_METRICS"
HOROVOD_METRICS_PUSH_SECS = "HOROVOD_METRICS_PUSH_SECS"
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_WIRE_COMPRESSION = "HOROVOD_WIRE_COMPRESSION"
HOROVOD_WIRE_EF = "HOROVOD_WIRE_EF"
HOROVOD_NEGOTIATION_FANIN = "HOROVOD_NEGOTIATION_FANIN"
HOROVOD_NEGOTIATION_FANIN_DIR = "HOROVOD_NEGOTIATION_FANIN_DIR"
HOROVOD_NEGOTIATION_FANIN_HEARTBEAT_SECS = \
    "HOROVOD_NEGOTIATION_FANIN_HEARTBEAT_SECS"
HOROVOD_NEGOTIATION_FANIN_VETO_EPOCHS = "HOROVOD_NEGOTIATION_FANIN_VETO_EPOCHS"
HOROVOD_CONTROLLER_TOPOLOGY = "HOROVOD_CONTROLLER_TOPOLOGY"
# The JAX package's XLA plane's coordination service.
HOROVOD_JAX_COORDINATOR = "HOROVOD_JAX_COORDINATOR"
HOROVOD_RING_SEGMENT_BYTES = "HOROVOD_RING_SEGMENT_BYTES"
HOROVOD_NUM_FINALIZER_THREADS = "HOROVOD_NUM_FINALIZER_THREADS"
HOROVOD_PIPELINE_DISPATCH = "HOROVOD_PIPELINE_DISPATCH"

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_STALL_CHECK_TIME_SECONDS = 60
DEFAULT_STALL_SHUTDOWN_TIME_SECONDS = 0  # disabled
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_STRAGGLER_THRESHOLD_SECS = 5.0
DEFAULT_STRAGGLER_EWMA_ALPHA = 0.25
DEFAULT_STRAGGLER_DEMOTE_SECS = 0.0
DEFAULT_STRAGGLER_DEMOTE_CYCLES = 10
DEFAULT_FLIGHT_RECORDER_EVENTS = 512
DEFAULT_MESH_STARTUP_TIMEOUT = 60.0

PLANE_HOST = "cpu"
PLANE_NCCL = "nccl"


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


def data_plane() -> str:
    """``HOROVOD_DATA_PLANE`` as :data:`PLANE_HOST` or :data:`PLANE_NCCL`.
    Any other value raises: the JAX package's ``auto`` (which falls back
    silently) and ``xla`` do not exist here."""
    plane = get_str(HOROVOD_DATA_PLANE).strip().lower() or PLANE_HOST
    if plane in (PLANE_HOST, "tcp"):
        return PLANE_HOST
    if plane == PLANE_NCCL:
        return PLANE_NCCL
    raise ValueError(
        f"{HOROVOD_DATA_PLANE}={plane!r}: expected {PLANE_HOST!r} (or "
        f"'tcp'), the host plane, or {PLANE_NCCL!r}, the device plane")


def _given(name: str) -> bool:
    return get_str(name).strip() != ""


def _on(name: str) -> bool:
    return _given(name) and get_bool(name)


def _forced_on(name: str) -> bool:
    return get_str(name).strip().lower() in ("1", "true", "yes", "on")


_TIMELINE = "ROADMAP A2 (the timeline)"
_TUNING = "ROADMAP A7 (autotune and the metrics export)"
_CROSS_HOST = "ROADMAP A9 (the cross-host transport)"

#: (knob, whether the JAX runtime acts on its value, the slice that brings
#: its feature to the port).  A boolean knob is set when ``get_bool`` reads
#: it true; a path or a number when it is not empty;
#: ``HOROVOD_HIERARCHICAL_ALLREDUCE`` when it is not one of the values that
#: turn it off (``cpu_ring.py``'s "0", "false", "False");
#: ``HOROVOD_WIRE_COMPRESSION`` when it names a codec; the fan-in when
#: forced on; the topology when it asks for the tree.
UNSUPPORTED_KNOBS = (
    (HOROVOD_TIMELINE, _given, _TIMELINE),
    (HOROVOD_TIMELINE_MARK_CYCLES, _on, _TIMELINE),
    (HOROVOD_TIMELINE_LIFECYCLE, _on, _TIMELINE),
    (HOROVOD_TIMELINE_CONTROL_PLANE, _on, _TIMELINE),
    (HOROVOD_AUTOTUNE, _on, _TUNING),
    (HOROVOD_AUTOTUNE_LOG, _given, _TUNING),
    (HOROVOD_AUTOTUNE_CODEC, _on, _TUNING),
    (HOROVOD_AUTOTUNE_WARMUP_SAMPLES, _given, _TUNING),
    (HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, _given, _TUNING),
    (HOROVOD_METRICS, _on, _TUNING),
    (HOROVOD_METRICS_PUSH_SECS, _given, _TUNING),
    (HOROVOD_ELASTIC, _on, "ROADMAP A6 (elastic)"),
    (HOROVOD_HIERARCHICAL_ALLREDUCE,
     lambda n: _given(n) and get_str(n).strip() not in ("0", "false",
                                                        "False"),
     _CROSS_HOST),
    (HOROVOD_WIRE_COMPRESSION,
     lambda n: get_str(n).strip().lower() not in ("", "none"), _CROSS_HOST),
    (HOROVOD_WIRE_EF, _on, _CROSS_HOST),
    (HOROVOD_NEGOTIATION_FANIN, _forced_on, _CROSS_HOST),
    (HOROVOD_NEGOTIATION_FANIN_DIR, _given, _CROSS_HOST),
    (HOROVOD_NEGOTIATION_FANIN_HEARTBEAT_SECS, _given, _CROSS_HOST),
    (HOROVOD_NEGOTIATION_FANIN_VETO_EPOCHS, _given, _CROSS_HOST),
    (HOROVOD_CONTROLLER_TOPOLOGY,
     lambda n: get_str(n).strip().lower() == "tree", _CROSS_HOST),
)

#: Knobs that only tune machinery of the JAX runtime with no counterpart
#: here (its ring's segments, its finalizer pool, its dispatch pipeline).
TUNING_ONLY_KNOBS = (HOROVOD_RING_SEGMENT_BYTES,
                     HOROVOD_NUM_FINALIZER_THREADS, HOROVOD_PIPELINE_DISPATCH)


def check_knobs() -> list:
    """Raise ``ValueError`` naming every set knob of
    :data:`UNSUPPORTED_KNOBS` with its slice, and ``HOROVOD_JAX_COORDINATOR``
    when it is set; return the set knobs of :data:`TUNING_ONLY_KNOBS`,
    which the caller warns about."""
    problems = [f"{name}={get_str(name)!r} needs {where}, which this port "
                f"does not have yet"
                for name, is_set, where in UNSUPPORTED_KNOBS if is_set(name)]
    if _given(HOROVOD_JAX_COORDINATOR):
        problems.append(
            f"{HOROVOD_JAX_COORDINATOR} is the JAX package's XLA plane's "
            f"coordinator; this port has no JAX plane: its device plane is "
            f"{HOROVOD_DATA_PLANE}={PLANE_NCCL}")
    if problems:
        raise ValueError("hvd.init(): " + "; ".join(problems) + ". Unset "
                         "them to run without these features.")
    return [name for name in TUNING_ONLY_KNOBS if _given(name)]
