"""The rendezvous store's scope names: every key of the elastic control
plane lives under one of these.

The port's copy of ``horovod_tpu/transport/scopes.py``.  A scope name is a
contract between processes that share no code at run time (the driver in
the launcher, the workers' rendezvous client and runtime), and a typo in
one of them reads an empty scope and times out; so the literals live here
only.
"""

from __future__ import annotations

#: Driver-private scope: the epoch it published last, at ``"epoch"``, and
#: the commit record of a reshard, at ``"reshard_commit"``.
DRIVER_SCOPE = "driver"

#: Driver -> worker slot table: ``hostname:local_rank`` -> rank, size and
#: epoch as JSON.  Rank -1 means "removed, exit".
RANK_AND_SIZE_SCOPE = "rank_and_size"

#: Worker -> driver adoption ack: each identity posts the epoch it adopted
#: so the driver stops re-notifying it.
EPOCH_ACK_SCOPE = "epoch_ack"

#: Worker -> driver liveness: each identity's lease, judged by the time its
#: value last changed on the driver's clock.
LEASE_SCOPE = "lease"

#: Worker -> driver reset requests: ``{"epoch": N, "reason": ...}`` from a
#: surviving worker whose collective failed (current-epoch requests only).
RESET_REQUEST_SCOPE = "reset_request"

#: Coordinator -> driver straggler verdicts: ``{"epoch": N, "rank": R,
#: ...}`` from the DemotionPolicy (current-epoch reports only).
DEMOTION_REPORT_SCOPE = "demotion_report"

#: Worker notify-server addresses, one key per identity.
WORKERS_SCOPE = "workers"

#: Worker metrics snapshots, one key per rank (``rank-<r>``).
METRICS_SCOPE = "metrics"
