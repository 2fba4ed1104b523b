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
