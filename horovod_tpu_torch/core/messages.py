"""Control-plane messages: Request / Response and the cycle's ResponseList.

Counterpart of ``horovod_tpu/core/messages.py`` (the reference's
``horovod/common/message.h:48-217``).  Every rank describes each tensor it
wants reduced with a ``Request``; the coordinator answers with fused
``Response``s naming the tensors that are ready.

The wire encoding (:class:`Writer`, :class:`Reader`,
``RequestList.to_bytes`` / ``ResponseList.to_bytes``) is the JAX package's,
byte for byte: little-endian fixed-width fields, length-prefixed strings and
lists.  The JAX lists also carry the response cache's fields (cache hits,
masks, assignments, evictions) and autotuned parameters; the port has no
response cache yet, so it writes them empty and refuses a frame that fills
them.  The mask frames are not ported.

``DataType`` maps to and from torch dtypes; bf16 is ``torch.bfloat16``.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import List, Sequence

import torch

from ..common.exceptions import TruncatedFrameError

WIRE_MAGIC = 0x48564454  # "HVDT"


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


class Writer:
    """Appends little-endian fields to a byte buffer."""

    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int): self.buf += struct.pack("<B", v)
    def u32(self, v: int): self.buf += struct.pack("<I", v)
    def i32(self, v: int): self.buf += struct.pack("<i", v)
    def i64(self, v: int): self.buf += struct.pack("<q", v)
    def f64(self, v: float): self.buf += struct.pack("<d", v)

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.buf += b

    def i64_list(self, xs: Sequence[int]):
        self.u32(len(xs))
        self.buf += struct.pack(f"<{len(xs)}q", *xs)

    def i32_list(self, xs: Sequence[int]):
        self.u32(len(xs))
        self.buf += struct.pack(f"<{len(xs)}i", *xs)

    def str_list(self, xs: Sequence[str]):
        self.u32(len(xs))
        for s in xs:
            self.string(s)

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class Reader:
    """Bounds-checked reader: a frame whose lengths point past its end
    raises :class:`TruncatedFrameError`, never a raw ``struct.error``."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _need(self, size: int) -> None:
        if self.pos + size > len(self.buf):
            raise TruncatedFrameError(
                f"frame truncated: need {size} bytes at offset {self.pos} "
                f"but only {len(self.buf) - self.pos} remain "
                f"(buffer is {len(self.buf)} bytes)")

    def _take(self, fmt: str, size: int):
        self._need(size)
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def u8(self) -> int: return self._take("<B", 1)
    def u32(self) -> int: return self._take("<I", 4)
    def i32(self) -> int: return self._take("<i", 4)
    def i64(self) -> int: return self._take("<q", 8)
    def f64(self) -> float: return self._take("<d", 8)

    def bytes_(self, n: int) -> bytes:
        self._need(n)
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out

    def string(self) -> str:
        return self.bytes_(self.u32()).decode("utf-8")

    def _list(self, code: str, size: int) -> List[int]:
        n = self.u32()
        self._need(size * n)
        out = list(struct.unpack_from(f"<{n}{code}", self.buf, self.pos))
        self.pos += size * n
        return out

    def i64_list(self) -> List[int]:
        return self._list("q", 8)

    def i32_list(self) -> List[int]:
        return self._list("i", 4)

    def str_list(self) -> List[str]:
        return [self.string() for _ in range(self.u32())]

    def expect_magic(self, what: str) -> None:
        got = self.u32()
        if got != WIRE_MAGIC:
            raise ValueError(
                f"bad {what} magic: got 0x{got:08X}, expected "
                f"0x{WIRE_MAGIC:08X}; first {min(16, len(self.buf))} bytes: "
                f"{bytes(self.buf[:16]).hex(' ')}")

    def expect_empty(self, n: int, what: str) -> None:
        """A field the port has no use for yet (the response cache's,
        autotuning's) must arrive empty."""
        if n:
            raise ValueError(f"{what} in a frame: this runtime has no "
                             "response cache or autotuning yet")


@dataclass
class Request:
    """One rank's declaration that a named tensor is ready
    (reference ``message.h:48-113``)."""

    request_rank: int = 0
    request_type: RequestType = RequestType.ALLREDUCE
    tensor_name: str = ""
    tensor_type: DataType = DataType.FLOAT32
    tensor_shape: List[int] = field(default_factory=list)
    root_rank: int = -1          # broadcast only
    device: int = -1             # CUDA device index; -1 = host memory
    group_id: int = -1           # grouped allreduce
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    splits: List[int] = field(default_factory=list)   # alltoall only

    def serialize(self, w: Writer) -> None:
        w.u32(self.request_rank)
        w.u8(int(self.request_type))
        w.string(self.tensor_name)
        w.u8(int(self.tensor_type))
        w.i64_list(self.tensor_shape)
        w.i32(self.root_rank)
        w.i32(self.device)
        w.i32(self.group_id)
        w.f64(self.prescale_factor)
        w.f64(self.postscale_factor)
        w.i64_list(self.splits)

    @staticmethod
    def deserialize(r: Reader) -> "Request":
        return Request(
            request_rank=r.u32(),
            request_type=RequestType(r.u8()),
            tensor_name=r.string(),
            tensor_type=DataType(r.u8()),
            tensor_shape=r.i64_list(),
            root_rank=r.i32(),
            device=r.i32(),
            group_id=r.i32(),
            prescale_factor=r.f64(),
            postscale_factor=r.f64(),
            splits=r.i64_list(),
        )

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
    last_joined_rank: int = -1

    def serialize(self, w: Writer) -> None:
        w.u8(int(self.response_type))
        w.str_list(self.tensor_names)
        w.u8(int(self.tensor_type))
        w.i64_list(self.tensor_sizes)
        w.string(self.error_message)
        w.i32_list(self.devices)
        w.f64(self.prescale_factor)
        w.f64(self.postscale_factor)
        w.i32(self.last_joined_rank)

    @staticmethod
    def deserialize(r: Reader) -> "Response":
        return Response(
            response_type=ResponseType(r.u8()),
            tensor_names=r.str_list(),
            tensor_type=DataType(r.u8()),
            tensor_sizes=r.i64_list(),
            error_message=r.string(),
            devices=r.i32_list(),
            prescale_factor=r.f64(),
            postscale_factor=r.f64(),
            last_joined_rank=r.i32(),
        )


@dataclass
class RequestList:
    """One rank's requests of a cycle, and whether it asks to shut down."""

    requests: List[Request] = field(default_factory=list)
    shutdown: bool = False

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(WIRE_MAGIC)
        w.u8(1 if self.shutdown else 0)
        w.i32_list([])      # cache hits
        w.u32(0)            # cache mask bytes
        w.u32(len(self.requests))
        for req in self.requests:
            req.serialize(w)
        return w.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "RequestList":
        r = Reader(data)
        r.expect_magic("request-list")
        shutdown = bool(r.u8())
        r.expect_empty(len(r.i32_list()), "cache hits")
        r.expect_empty(r.u32(), "a cache mask")
        reqs = [Request.deserialize(r) for _ in range(r.u32())]
        return RequestList(requests=reqs, shutdown=shutdown)


@dataclass
class ResponseList:
    """The coordinator's verdict of a cycle, which every rank executes in
    order, and whether the job shuts down."""

    responses: List[Response] = field(default_factory=list)
    shutdown: bool = False

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(WIRE_MAGIC)
        w.u8(1 if self.shutdown else 0)
        w.i32_list([])      # evicted cache bits
        w.u32(0)            # cache assignments
        w.u8(0)             # no autotuned parameters
        w.u32(len(self.responses))
        for resp in self.responses:
            resp.serialize(w)
        return w.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "ResponseList":
        r = Reader(data)
        r.expect_magic("response-list")
        shutdown = bool(r.u8())
        r.expect_empty(len(r.i32_list()), "evicted cache bits")
        r.expect_empty(r.u32(), "cache assignments")
        r.expect_empty(r.u8(), "autotuned parameters")
        resps = [Response.deserialize(r) for _ in range(r.u32())]
        return ResponseList(responses=resps, shutdown=shutdown)
