"""Framework exceptions (counterpart of ``horovod_tpu/common/exceptions.py``;
the reference's ``horovod/common/exceptions.py``)."""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective operation fails, or when the
    runtime is used outside what it supports."""


class HostsUpdatedInterrupt(RuntimeError):
    """The elastic driver reported a change of the host set; raised at the
    next ``state.commit()`` / ``check_host_updates()`` (reference
    ``common/exceptions.py:20``).  ``skip_sync`` is true only when every
    change since the last one consumed was a removal: then every remaining
    process already holds the committed state and the post-reset broadcast
    is skipped."""

    def __init__(self, skip_sync: bool = False):
        super().__init__(f"hosts updated (skip_sync={skip_sync})")
        self.skip_sync = skip_sync


class DuplicateNameError(ValueError):
    """A tensor with the same name is already in flight.

    Reference: ``DUPLICATE_NAME_ERROR`` status (``common.h:164-167``)."""


class TruncatedFrameError(HorovodInternalError):
    """A control-plane frame ended mid-field while being parsed
    (``core/messages.py`` ``Reader``): its declared lengths point past the
    end of the buffer."""


class FaultInjectedError(HorovodInternalError):
    """Raised by ``common/faults.py`` for ``action=raise``: it takes every
    path that a real collective failure takes."""


class CheckpointNotFoundError(FileNotFoundError):
    """``checkpoint.restore``/``restore_latest`` found no (valid) snapshot.
    Raised on every rank (rank 0's verdict is broadcast), so that callers
    can ``try: restore(...)`` and fall back to a fresh start instead of the
    ``exists()`` + ``restore()`` pair, which races."""
