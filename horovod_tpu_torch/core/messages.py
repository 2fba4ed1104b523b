"""Control-plane messages: Request / Response, the cycle's lists, and the
steady-state and abort frames.

Counterpart of ``horovod_tpu/core/messages.py`` (the reference's
``horovod/common/message.h:48-217``).  Every rank describes each tensor it
wants reduced with a ``Request``; the coordinator answers with fused
``Response``s naming the tensors that are ready.

The wire encoding (:class:`Writer`, :class:`Reader`, the lists' and
frames' ``to_bytes``) is the JAX package's, byte for byte: little-endian
fixed-width fields, length-prefixed strings and lists.  The lists carry
the response cache's fields (``core/response_cache.py``): a worker's cache
hits as a bitmask, the coordinator's bit assignments and evictions.  A
:class:`MaskFrame` is a whole cycle's contribution or verdict when every
tensor of it is cached; an :class:`AbortFrame` is the verdict of a cycle
in which the coordinator failed.  The JAX lists also carry autotuned
parameters; the port has no autotuning, so it writes that field empty
and refuses a frame that fills it.

``DataType`` maps to and from torch dtypes; bf16 is ``torch.bfloat16``.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import torch

from ..common.exceptions import TruncatedFrameError

WIRE_MAGIC = 0x48564454  # "HVDT"
MASK_MAGIC = 0x4B53414D  # "MASK": the steady-state frame
ABORT_MAGIC = 0x54524241  # "ABRT": the coordinated-abort frame
#: An abort reason's cap in UTF-8 bytes, the truncation mark included.
MAX_ABORT_REASON_BYTES = 512
_TRUNCATION_MARK = "…[truncated]"


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

    def expect_magic(self, what: str, magic: int = WIRE_MAGIC) -> None:
        got = self.u32()
        if got != magic:
            raise ValueError(
                f"bad {what} magic: got 0x{got:08X}, expected "
                f"0x{magic:08X}; first {min(16, len(self.buf))} bytes: "
                f"{bytes(self.buf[:16]).hex(' ')}")


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
    """One rank's requests of a cycle, and whether it asks to shut down.
    A cached tensor travels as its bit: ``cache_mask`` is the little-endian
    bytes of the bitmask of this rank's hits (``cache_hits``, a list of bit
    positions, is the JAX package's older flavor of the same, still read)."""

    requests: List[Request] = field(default_factory=list)
    shutdown: bool = False
    cache_hits: List[int] = field(default_factory=list)
    cache_mask: bytes = b""

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(WIRE_MAGIC)
        w.u8(1 if self.shutdown else 0)
        w.i32_list(self.cache_hits)
        w.u32(len(self.cache_mask))
        w.buf += self.cache_mask
        w.u32(len(self.requests))
        for req in self.requests:
            req.serialize(w)
        return w.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "RequestList":
        r = Reader(data)
        r.expect_magic("request-list")
        shutdown = bool(r.u8())
        cache_hits = r.i32_list()
        mask = r.bytes_(r.u32())
        reqs = [Request.deserialize(r) for _ in range(r.u32())]
        return RequestList(requests=reqs, shutdown=shutdown,
                           cache_hits=cache_hits, cache_mask=mask)


def _has_magic(data: bytes, magic: int) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data)[0] == magic


@dataclass
class MaskFrame:
    """A cycle as a bitmask alone, in both directions: a worker whose every
    pending tensor hit its cache mirror sends its hits (an idle worker an
    empty mask); a coordinator whose cycle was all cache bits on every rank
    answers with the agreed bits, from which each rank rebuilds the
    responses out of its cached templates."""

    mask: bytes = b""        # little-endian bitmask
    shutdown: bool = False

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(MASK_MAGIC)
        w.u8(1 if self.shutdown else 0)
        w.u32(len(self.mask))
        w.buf += self.mask
        return w.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "MaskFrame":
        r = Reader(data)
        r.expect_magic("mask-frame", MASK_MAGIC)
        shutdown = bool(r.u8())
        return MaskFrame(mask=r.bytes_(r.u32()), shutdown=shutdown)

    @property
    def mask_int(self) -> int:
        return int.from_bytes(self.mask, "little")


def is_mask_frame(data: bytes) -> bool:
    return _has_magic(data, MASK_MAGIC)


@dataclass
class AbortFrame:
    """The verdict of a cycle in which the coordinator failed: every rank
    raises ``reason``.  ``epoch`` is the membership epoch (0 until elastic
    re-init exists); the reason is capped at :data:`MAX_ABORT_REASON_BYTES`
    when the frame is built."""

    epoch: int = 0
    origin_rank: int = 0
    reason: str = ""

    def __post_init__(self):
        raw = self.reason.encode("utf-8")
        if len(raw) > MAX_ABORT_REASON_BYTES:
            mark = _TRUNCATION_MARK.encode("utf-8")
            keep = raw[:MAX_ABORT_REASON_BYTES - len(mark)]
            # A multi-byte character cut in two is dropped whole.
            self.reason = keep.decode("utf-8", "ignore") + _TRUNCATION_MARK

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(ABORT_MAGIC)
        w.i64(self.epoch)
        w.i32(self.origin_rank)
        w.string(self.reason)
        return w.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "AbortFrame":
        r = Reader(data)
        r.expect_magic("abort-frame", ABORT_MAGIC)
        return AbortFrame(epoch=r.i64(), origin_rank=r.i32(),
                          reason=r.string())


def is_abort_frame(data: bytes) -> bool:
    return _has_magic(data, ABORT_MAGIC)


@dataclass
class ResponseList:
    """The coordinator's verdict of a cycle, which every rank executes in
    order, and whether the job shuts down; with the cache's maintenance,
    which the workers mirror: (bit, request template) assignments, then
    evicted bits."""

    responses: List[Response] = field(default_factory=list)
    shutdown: bool = False
    cache_assignments: List[Tuple[int, Request]] = field(default_factory=list)
    evicted_bits: List[int] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        w = Writer()
        w.u32(WIRE_MAGIC)
        w.u8(1 if self.shutdown else 0)
        w.i32_list(self.evicted_bits)
        w.u32(len(self.cache_assignments))
        for bit, template in self.cache_assignments:
            w.i32(bit)
            template.serialize(w)
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
        evicted = r.i32_list()
        assignments = [(r.i32(), Request.deserialize(r))
                       for _ in range(r.u32())]
        if r.u8():
            raise ValueError("autotuned parameters in a frame: this runtime "
                             "has no autotuning")
        resps = [Response.deserialize(r) for _ in range(r.u32())]
        return ResponseList(responses=resps, shutdown=shutdown,
                            cache_assignments=assignments,
                            evicted_bits=evicted)
