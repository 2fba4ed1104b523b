"""Control-plane messages: Request / Response and the cycle's ResponseList.

Counterpart of ``horovod_tpu/core/messages.py`` (the reference's
``horovod/common/message.h:48-217``).  Every rank describes each tensor it
wants reduced with a ``Request``; the controller answers with fused
``Response``s naming the tensors that are ready.  At one process the
messages never leave it, so the wire encoding waits for the transport slice.

``DataType`` maps to and from torch dtypes; bf16 is ``torch.bfloat16``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List

import torch


class DataType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10

    @property
    def itemsize(self) -> int:
        return _TO_TORCH[self].itemsize

    def to_torch(self) -> torch.dtype:
        return _TO_TORCH[self]

    @staticmethod
    def from_torch(dtype: torch.dtype) -> "DataType":
        try:
            return _FROM_TORCH[dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {dtype!r}") from None


_TO_TORCH = {
    DataType.UINT8: torch.uint8, DataType.INT8: torch.int8,
    DataType.UINT16: torch.uint16, DataType.INT16: torch.int16,
    DataType.INT32: torch.int32, DataType.INT64: torch.int64,
    DataType.FLOAT16: torch.float16, DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64, DataType.BOOL: torch.bool,
    DataType.BFLOAT16: torch.bfloat16,
}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}


class RequestType(enum.IntEnum):
    """Reference ``message.h:51``; numbering shared with the JAX package."""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    ERROR = 7


@dataclass
class Request:
    """One rank's declaration that a named tensor is ready
    (reference ``message.h:48-113``)."""

    request_rank: int = 0
    request_type: RequestType = RequestType.ALLREDUCE
    tensor_name: str = ""
    tensor_type: DataType = DataType.FLOAT32
    tensor_shape: List[int] = field(default_factory=list)
    device: int = -1             # CUDA device index; -1 = host memory
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.tensor_shape:
            n *= d
        return n


@dataclass
class Response:
    """Controller verdict for one (possibly fused) set of tensors
    (reference ``message.h:145-217``)."""

    response_type: ResponseType = ResponseType.ALLREDUCE
    tensor_names: List[str] = field(default_factory=list)
    tensor_type: DataType = DataType.FLOAT32
    tensor_sizes: List[int] = field(default_factory=list)
    error_message: str = ""
    devices: List[int] = field(default_factory=list)
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0


@dataclass
class ResponseList:
    responses: List[Response] = field(default_factory=list)
    shutdown: bool = False
