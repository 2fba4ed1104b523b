"""Object (de)serialization for the object collectives: cloudpickle when
available (closures, lambdas), stdlib pickle otherwise.

The port's own copy of ``horovod_tpu/common/pickling.py``.
"""

from __future__ import annotations


def _pickler():
    try:
        import cloudpickle

        return cloudpickle
    except ImportError:
        import pickle

        return pickle


def dumps(obj) -> bytes:
    return _pickler().dumps(obj)


def loads(blob: bytes):
    return _pickler().loads(blob)
