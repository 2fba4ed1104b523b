"""Framework exceptions (counterpart of ``horovod_tpu/common/exceptions.py``;
the reference's ``horovod/common/exceptions.py``)."""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective operation fails, or when the
    runtime is used outside what it supports."""


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
