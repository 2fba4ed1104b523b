"""Elastic constants: the port's copy of ``horovod_tpu/elastic/constants.py``
(reference ``runner/elastic/constants.py``)."""

# Exit code a worker uses when it gives up after repeated re-init failures
# (rendezvous unreachable, mesh rebuild timeout).  The driver treats this as
# a *transient* casualty — respawn the identity, count toward a higher
# blacklist threshold — distinct from a crash/kill exit, which indicates the
# host itself is suspect (a survivor dying because its peer died must not
# blacklist the survivor's host).
TRANSIENT_EXIT_CODE = 73

# A host is blacklisted after this many crash-type worker exits ...
DEFAULT_CRASH_FAILURE_LIMIT = 1
# ... or this many transient-type exits (re-init gave up).
DEFAULT_TRANSIENT_FAILURE_LIMIT = 3

DISCOVER_HOSTS_FREQUENCY_SECS = 1.0
ELASTIC_TIMEOUT_SECS = 600.0

# Worker-side: consecutive re-init failures before exiting with
# TRANSIENT_EXIT_CODE so the driver can respawn a fresh process.
WORKER_REINIT_ATTEMPTS = 3
