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
# The HTTP rendezvous server (runner/rendezvous.py): the elastic scopes,
# the leases and ``GET /clock``.
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
# The launcher's ``TCPStore`` (transport/store.py): the process groups'
# rendezvous and the card table, which need c10d's blocking waits.  Only
# the launcher sets them.
HOROVOD_TORCH_STORE_ADDR = "HOROVOD_TORCH_STORE_ADDR"
HOROVOD_TORCH_STORE_PORT = "HOROVOD_TORCH_STORE_PORT"
# The job's key for the signed elastic notify pings (common/secret.py).
HOROVOD_SECRET_KEY = "HOROVOD_SECRET_KEY"
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

# -- deterministic fault injection (common/faults.py): the spec, read when
# the package is imported; unset means no injection --
HOROVOD_FAULT_SPEC = "HOROVOD_FAULT_SPEC"

# -- elastic (horovod_tpu_torch/elastic/): set by the elastic launcher --
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
# The membership epoch this process runs at (0 outside elastic jobs); it
# scopes the process groups' store keys and every worker -> driver post.
HOROVOD_EPOCH = "HOROVOD_EPOCH"
HOROVOD_ELASTIC_RESET_LIMIT = "HOROVOD_ELASTIC_RESET_LIMIT"
# A host is blacklisted after this many crash exits of its workers, or this
# many transient ones (a worker that gave up re-initializing).
HOROVOD_ELASTIC_CRASH_FAILURE_LIMIT = "HOROVOD_ELASTIC_CRASH_FAILURE_LIMIT"
HOROVOD_ELASTIC_TRANSIENT_FAILURE_LIMIT = \
    "HOROVOD_ELASTIC_TRANSIENT_FAILURE_LIMIT"
# The driver declares a worker dead when its lease value has not changed
# for this many seconds.
HOROVOD_LEASE_TIMEOUT_SECS = "HOROVOD_LEASE_TIMEOUT_SECS"
# "0" turns the reshard marker off: every epoch then syncs from rank 0.
HOROVOD_RESHARD = "HOROVOD_RESHARD"
# Seconds a blacklisted host stays out; 0, the default, is for good.
HOROVOD_BLACKLIST_COOLDOWN_SECS = "HOROVOD_BLACKLIST_COOLDOWN_SECS"
# host:port of a rendezvous server that a supervisor runs (``python -m
# horovod_tpu_torch.runner.rendezvous``): the launchers attach to it
# instead of hosting one.
HOROVOD_RENDEZVOUS_EXTERNAL = "HOROVOD_RENDEZVOUS_EXTERNAL"
# The server's write-ahead journal and snapshots (transport/journal.py);
# unset: no journal.  FSYNC ("1"/"0", default on) syncs each record;
# SNAPSHOT_EVERY is the ops between two compactions.
HOROVOD_RENDEZVOUS_JOURNAL_DIR = "HOROVOD_RENDEZVOUS_JOURNAL_DIR"
HOROVOD_RENDEZVOUS_JOURNAL_FSYNC = "HOROVOD_RENDEZVOUS_JOURNAL_FSYNC"
HOROVOD_RENDEZVOUS_SNAPSHOT_EVERY = "HOROVOD_RENDEZVOUS_SNAPSHOT_EVERY"
# ``POST /batch`` ("1"/"0", default on; off on the server answers 404 and
# the client falls back to one request per op), and its ops per request.
HOROVOD_RENDEZVOUS_BATCH = "HOROVOD_RENDEZVOUS_BATCH"
HOROVOD_RENDEZVOUS_BATCH_MAX_OPS = "HOROVOD_RENDEZVOUS_BATCH_MAX_OPS"
# Seconds between two renewals of a worker's lease, each with its metrics
# snapshot (elastic/rendezvous_client.py); 0 turns the renewals off.
HOROVOD_METRICS_PUSH_SECS = "HOROVOD_METRICS_PUSH_SECS"

# -- logging --
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIMESTAMP = "HOROVOD_LOG_HIDE_TIMESTAMP"

# -- the timeline (core/timeline.py): the trace's path (rank r writes
# <path>.rank<r>), a CYCLE mark per cycle, and the per-tensor LC_* spans
# (default on) --
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_TIMELINE_LIFECYCLE = "HOROVOD_TIMELINE_LIFECYCLE"
# The control-plane spans ("1"/"0", default on): RVC_* store round trips,
# the driver's DRV_* and CHURN_EVENT, the server's RV_* and JR_*.
HOROVOD_TIMELINE_CONTROL_PLANE = "HOROVOD_TIMELINE_CONTROL_PLANE"
# The rendezvous server's own trace (its pid is SERVER_TRACE_PID).
HOROVOD_SERVER_TIMELINE = "HOROVOD_SERVER_TIMELINE"

# -- knobs of the JAX runtime that this port does not act on.  A job that
# sets one of the first group gets an error at ``hvd.init()`` naming the
# slice that brings its feature (ROADMAP.md A7, A8, A9), instead of a run
# without it; the second group only tunes machinery the port does not
# have, and gets one warning. --
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_CODEC = "HOROVOD_AUTOTUNE_CODEC"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_METRICS = "HOROVOD_METRICS"
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
HOROVOD_LOCK_DEBUG = "HOROVOD_LOCK_DEBUG"
HOROVOD_LOCK_DEBUG_SLOW_SECS = "HOROVOD_LOCK_DEBUG_SLOW_SECS"
HOROVOD_SPARK_INLINE_MAX_ROWS = "HOROVOD_SPARK_INLINE_MAX_ROWS"
HOROVOD_TPU_MESH_AXES = "HOROVOD_TPU_MESH_AXES"
HOROVOD_TRANSPORT = "HOROVOD_TRANSPORT"
HOROVOD_WIRE_CRC = "HOROVOD_WIRE_CRC"
HOROVOD_WIRE_CRC_SHADOW = "HOROVOD_WIRE_CRC_SHADOW"
HOROVOD_WIRE_DIGEST = "HOROVOD_WIRE_DIGEST"
HOROVOD_SHM_CRC = "HOROVOD_SHM_CRC"
HOROVOD_FANIN = "HOROVOD_FANIN"
HOROVOD_FANIN_DIR = "HOROVOD_FANIN_DIR"
HOROVOD_TCP_PROGRESS_DEADLINE_SECS = "HOROVOD_TCP_PROGRESS_DEADLINE_SECS"
HOROVOD_SHM_RING_BYTES = "HOROVOD_SHM_RING_BYTES"
HOROVOD_SHM_HOSTID = "HOROVOD_SHM_HOSTID"
HOROVOD_DISABLE_NATIVE = "HOROVOD_DISABLE_NATIVE"
HOROVOD_FLASH_ATTENTION = "HOROVOD_FLASH_ATTENTION"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = \
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = \
    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"
HOROVOD_CONTROLLER = "HOROVOD_CONTROLLER"
HOROVOD_CPU_OPERATIONS = "HOROVOD_CPU_OPERATIONS"
HOROVOD_ADASUM_MPI_CHUNK_SIZE = "HOROVOD_ADASUM_MPI_CHUNK_SIZE"
HOROVOD_XLA_BUCKET_BYTES = "HOROVOD_XLA_BUCKET_BYTES"

#: Names that the JAX package reads only in tooling that no slice of the
#: port brings: its cluster simulator (``horovod_tpu/sim/``) and the
#: TPU-VM metadata discovery (on a GPU host the discovery script takes
#: its role).  The port neither reads nor checks them.
JAX_TOOLING_ONLY_KNOBS = ("HOROVOD_SIM_LATENCY_MS", "HOROVOD_SIM_JITTER_MS",
                          "HOROVOD_SIM_BANDWIDTH_MBS", "HOROVOD_SIM_SEED",
                          "HOROVOD_TPU_METADATA_URL")

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
DEFAULT_METRICS_PUSH_SECS = 5.0
DEFAULT_LEASE_TIMEOUT_SECS = 15.0
DEFAULT_RENDEZVOUS_SNAPSHOT_EVERY = 512
DEFAULT_RENDEZVOUS_BATCH_MAX_OPS = 512

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


def get_epoch() -> int:
    """The elastic membership epoch (0 outside elastic jobs)."""
    return get_int(HOROVOD_EPOCH, 0)


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


_TUNING = "ROADMAP A7 (autotune and the metrics export)"
_LOCKDEP = "ROADMAP A7 (common/lockdep.py, the lock-order validator)"
_SPARK = "ROADMAP A7 (spark/, pointed at the port's API)"
_PARALLEL = "ROADMAP A8 (parallel/ and the launcher's --mesh-axes)"
_CROSS_HOST = "ROADMAP A9 (the cross-host transport)"

#: (knob, whether the JAX runtime acts on its value, the slice that brings
#: its feature to the port).  A boolean knob is set when ``get_bool`` reads
#: it true; a path or a number when it is not empty;
#: ``HOROVOD_HIERARCHICAL_ALLREDUCE`` when it is not one of the values that
#: turn it off (``cpu_ring.py``'s "0", "false", "False");
#: ``HOROVOD_WIRE_COMPRESSION`` when it names a codec; the fan-in when
#: forced on; the topology when it asks for the tree.
UNSUPPORTED_KNOBS = (
    (HOROVOD_AUTOTUNE, _on, _TUNING),
    (HOROVOD_AUTOTUNE_LOG, _given, _TUNING),
    (HOROVOD_AUTOTUNE_CODEC, _on, _TUNING),
    (HOROVOD_AUTOTUNE_WARMUP_SAMPLES, _given, _TUNING),
    (HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, _given, _TUNING),
    (HOROVOD_METRICS, _on, _TUNING),
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
    (HOROVOD_LOCK_DEBUG, _on, _LOCKDEP),
    (HOROVOD_LOCK_DEBUG_SLOW_SECS, _given, _LOCKDEP),
    (HOROVOD_SPARK_INLINE_MAX_ROWS, _given, _SPARK),
    (HOROVOD_TPU_MESH_AXES, _given, _PARALLEL),
    (HOROVOD_TRANSPORT, lambda n: get_str(n).strip().lower() == "shm",
     _CROSS_HOST),
    (HOROVOD_WIRE_CRC, _forced_on, _CROSS_HOST),
    (HOROVOD_WIRE_CRC_SHADOW, _forced_on, _CROSS_HOST),
    (HOROVOD_WIRE_DIGEST, _forced_on, _CROSS_HOST),
    (HOROVOD_SHM_CRC, _forced_on, _CROSS_HOST),
    (HOROVOD_FANIN, _forced_on, _CROSS_HOST),
    (HOROVOD_FANIN_DIR, _given, _CROSS_HOST),
)

#: Knobs that only tune machinery of the JAX runtime with no counterpart
#: here, or that it defines and never reads; each gets one warning.
TUNING_ONLY_KNOBS = (
    HOROVOD_RING_SEGMENT_BYTES,          # its ring's segments
    HOROVOD_NUM_FINALIZER_THREADS,       # its XLA finalizer pool
    HOROVOD_PIPELINE_DISPATCH,           # its dispatch pipeline
    HOROVOD_TCP_PROGRESS_DEADLINE_SECS,  # its TCP mesh; gloo has its own
    HOROVOD_SHM_RING_BYTES,              # its shared-memory rings
    HOROVOD_SHM_HOSTID,                  # its shm link classification
    HOROVOD_DISABLE_NATIVE,              # its C++ helpers (_native/)
    HOROVOD_FLASH_ATTENTION,             # the port picks by attention_impl
    HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES,   # autotune, refused above
    HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE,  # autotune, refused above
    HOROVOD_CONTROLLER,                  # set by its launcher, never read
    HOROVOD_CPU_OPERATIONS,              # defined there, never read
    HOROVOD_ADASUM_MPI_CHUNK_SIZE,       # defined there, never read
    HOROVOD_XLA_BUCKET_BYTES,            # defined there, never read
)


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
