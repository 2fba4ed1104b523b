"""Write-ahead journal and compacted snapshots for the rendezvous store.

The port's copy of ``horovod_tpu/transport/journal.py``, byte for byte the
same on disk: a journal written by either package replays in the other.
Every mutation of the rendezvous server's store (``runner/rendezvous.py``)
is appended as a length-prefixed, crc32-checked frame before it is applied,
and every ``snapshot_every`` ops the whole map is compacted into a
snapshot, so that a server SIGKILLed mid-job and restarted over the same
directory replays to its state before the kill.

On-disk layout (one directory per store)::

    snap-00000003        newest compacted snapshot (generation 3)
    journal-00000003     ops appended since that snapshot
    snap-00000002        previous generation, kept until the next compaction
    journal-00000002

Every file is a sequence of frames ``<Q payload_len><I crc32(payload)>``
followed by the payload.  A journal's first frame is the magic
``HVDJRNL1``; each later frame is one op, ``<B op><I key_len>key[value]``
with op 1 = SET, 2 = DELETE, or one atomic group (op 3): a batched
transaction as ``<B 3><I count>`` and ``count`` records ``<I len><op
record>``.  A snapshot is the magic ``HVDSNAP1``, one SET frame per key and
the end marker ``HVDSNAP-END``; a snapshot without its end marker is an
aborted compaction, and recovery ignores it.

Crash consistency:

- Longest valid prefix: a reader stops at the first frame whose header or
  payload is short or whose crc32 does not match, so a torn last write
  shortens the journal by the op being written and is never misparsed.
  Recovery truncates the torn tail, so that later appends extend the valid
  prefix.  A group is one frame: it replays whole or not at all.
- Snapshot, then switch: a compaction writes ``snap-<g+1>`` under a
  temporary name, fsyncs, renames it into place, and only then starts
  ``journal-<g+1>`` and prunes generation g-1.  A crash in between leaves
  an invalid or absent ``snap-<g+1>``, and recovery falls back to g.
- Write-ahead: the store appends (and by default syncs) the record before
  it applies the op, so an acknowledged write is durable.

:class:`StoreJournal`'s lock is a leaf: the store calls in holding its own
lock, and nothing is acquired under the journal's.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from ..common.logging_util import get_logger
from ..core import timeline as timeline_mod

log = get_logger("horovod_tpu_torch.transport.journal")

#: Frame header: payload length, crc32(payload).
_HDR = struct.Struct("<QI")
#: Op record prefix inside a frame payload: op byte, key length.
_OP = struct.Struct("<BI")

OP_SET = 1
OP_DELETE = 2
#: Atomic record group (batched rendezvous transaction): the frame
#: payload is ``<B 3><I count>`` + count × ``<I len><sub-op record>``,
#: each sub-op an OP_SET/OP_DELETE record.  Replays all-or-nothing
#: because the group shares one frame (one crc32).
OP_GROUP = 3

#: Length prefix of each sub-op record inside a group payload.
_GROUP_LEN = struct.Struct("<I")

JOURNAL_MAGIC = b"HVDJRNL1"
SNAP_MAGIC = b"HVDSNAP1"
SNAP_END = b"HVDSNAP-END"

#: Refuse to trust a length field past this: a corrupt header with a huge
#: length must read as "torn frame", not attempt a giant allocation.
_MAX_PAYLOAD = 256 * 1024 * 1024


def pack_frame(payload: bytes) -> bytes:
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def iter_frames(blob: bytes) -> Iterator[Tuple[int, bytes]]:
    """Yield ``(end_offset, payload)`` for every valid frame in order,
    stopping at the first torn or corrupt one (longest-valid-prefix)."""
    off = 0
    n = len(blob)
    while n - off >= _HDR.size:
        length, crc = _HDR.unpack_from(blob, off)
        start = off + _HDR.size
        if length > _MAX_PAYLOAD or length > n - start:
            return  # torn tail (or a corrupt length field)
        payload = blob[start:start + length]
        if zlib.crc32(payload) != crc:
            return
        off = start + length
        yield off, payload


def encode_op(op: int, key: str, value: bytes = b"") -> bytes:
    kb = key.encode("utf-8")
    return _OP.pack(op, len(kb)) + kb + value


def decode_op(payload: bytes) -> Tuple[int, str, bytes]:
    op, klen = _OP.unpack_from(payload)
    key_end = _OP.size + klen
    if key_end > len(payload):
        raise ValueError("op record shorter than its key length")
    key = payload[_OP.size:key_end].decode("utf-8")
    return op, key, bytes(payload[key_end:])


def encode_group(records: List[Tuple[int, str, bytes]]) -> bytes:
    """One frame payload for an atomic group of (op, key, value) records."""
    parts = [_OP.pack(OP_GROUP, len(records))]
    for op, key, value in records:
        rec = encode_op(op, key, value)
        parts.append(_GROUP_LEN.pack(len(rec)))
        parts.append(rec)
    return b"".join(parts)


def decode_group(payload: bytes) -> List[Tuple[int, str, bytes]]:
    """Inverse of :func:`encode_group`; raises ValueError on any
    structural mismatch (count vs records, truncated sub-record)."""
    op, count = _OP.unpack_from(payload)
    if op != OP_GROUP:
        raise ValueError(f"not a group record (op={op})")
    records: List[Tuple[int, str, bytes]] = []
    off = _OP.size
    for _ in range(count):
        if off + _GROUP_LEN.size > len(payload):
            raise ValueError("group record truncated at a length prefix")
        (rec_len,) = _GROUP_LEN.unpack_from(payload, off)
        off += _GROUP_LEN.size
        if off + rec_len > len(payload):
            raise ValueError("group sub-record shorter than its length")
        records.append(decode_op(payload[off:off + rec_len]))
        off += rec_len
    if off != len(payload):
        raise ValueError("trailing bytes after the last group sub-record")
    return records


class StoreJournal:
    """Journal + snapshot manager for one KV store directory.

    All mutating methods are expected to be called with the owning
    store's lock held (the store is the serialization point for op
    order); the internal ``_lock`` only protects the file handle against
    a concurrent ``close()`` and keeps compaction atomic, and is a leaf.
    """

    def __init__(self, dirpath: str, fsync: bool = True,
                 snapshot_every: int = 512,
                 trace: Optional["timeline_mod.Timeline"] = None):
        self._dir = dirpath
        self._fsync = fsync
        self._snapshot_every = max(1, int(snapshot_every))
        self._lock = threading.Lock()  # a leaf: see the module docstring
        self._fh = None
        self._gen = 0
        self._ops_since_snap = 0
        # The server's trace (JR_* spans), written after _lock is released.
        self._trace = trace
        os.makedirs(dirpath, exist_ok=True)

    # -- paths ---------------------------------------------------------

    def _snap_path(self, gen: int) -> str:
        return os.path.join(self._dir, f"snap-{gen:08d}")

    def _journal_path(self, gen: int) -> str:
        return os.path.join(self._dir, f"journal-{gen:08d}")

    def _generations(self) -> List[int]:
        gens = set()
        for name in os.listdir(self._dir):
            for prefix in ("snap-", "journal-"):
                if name.startswith(prefix) and not name.endswith(".tmp"):
                    try:
                        gens.add(int(name[len(prefix):]))
                    except ValueError:
                        continue
        return sorted(gens)

    # -- recovery ------------------------------------------------------

    def recover(self) -> Dict[str, bytes]:
        """Replay to the pre-crash KV state and arm the journal for
        appends (truncating any torn tail first).  Call exactly once,
        before the first append."""
        t0 = time.monotonic_ns()
        with self._lock:
            state, gen, valid_len, nops = self._recover_locked()
            self._gen = gen
            jpath = self._journal_path(gen)
            if os.path.exists(jpath) and os.path.getsize(jpath) > valid_len:
                torn = os.path.getsize(jpath) - valid_len
                log.warning("journal %s: truncating %d-byte torn tail "
                            "(replayed %d ops)", jpath, torn, nops)
                with open(jpath, "r+b") as f:
                    f.truncate(valid_len)
                    f.flush()
                    os.fsync(f.fileno())
            self._open_journal_locked(gen)
            self._ops_since_snap = nops
            if state or nops:
                log.info("rendezvous journal recovered: generation %d, "
                         "%d keys, %d journal ops", gen, len(state), nops)
        if self._trace is not None and timeline_mod.CONTROL_PLANE_ENABLED:
            self._trace.span_since("journal", "JR_REPLAY", t0,
                                   {"generation": self._gen, "ops": nops})
        return state

    def _recover_locked(self) -> Tuple[Dict[str, bytes], int, int, int]:
        for gen in sorted(self._generations(), reverse=True) or [0]:
            if gen == 0:
                base: Optional[Dict[str, bytes]] = {}
            else:
                base = self._read_snapshot(gen)
                if base is None:
                    # Aborted compaction (no end marker / torn): the
                    # previous generation still holds every op.
                    log.warning("snapshot generation %d invalid; falling "
                                "back to generation %d", gen, gen - 1)
                    continue
            state, valid_len, nops = self._replay_journal(gen, base)
            return state, gen, valid_len, nops
        return {}, 0, 0, 0

    def _read_snapshot(self, gen: int) -> Optional[Dict[str, bytes]]:
        path = self._snap_path(gen)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        frames = [p for _, p in iter_frames(blob)]
        if len(frames) < 2 or frames[0] != SNAP_MAGIC \
                or frames[-1] != SNAP_END:
            return None
        state: Dict[str, bytes] = {}
        for payload in frames[1:-1]:
            try:
                op, key, value = decode_op(payload)
            except (ValueError, struct.error):
                return None
            if op != OP_SET:
                return None
            state[key] = value
        return state

    def _replay_journal(self, gen: int, base: Dict[str, bytes]
                        ) -> Tuple[Dict[str, bytes], int, int]:
        """Apply the journal's longest valid prefix over ``base``; returns
        (state, byte length of the valid prefix, ops replayed)."""
        path = self._journal_path(gen)
        state = dict(base)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return state, 0, 0
        valid_len = 0
        nops = 0
        first = True
        for end, payload in iter_frames(blob):
            if first:
                first = False
                if payload != JOURNAL_MAGIC:
                    break  # foreign file: replay nothing, rewrite below
                valid_len = end
                continue
            # Dispatch on the op byte BEFORE decode_op: a group frame's
            # count/length fields are binary, and decode_op would try to
            # utf-8 them as a key.
            if payload and payload[0] == OP_GROUP:
                # Atomic group: the frame's crc already vouched for every
                # byte, so a structural decode error here is corruption —
                # stop (applying a partial group would break atomicity).
                try:
                    records = decode_group(payload)
                except (ValueError, struct.error):
                    break
                for gop, gkey, gvalue in records:
                    if gop == OP_SET:
                        state[gkey] = gvalue
                    elif gop == OP_DELETE:
                        state.pop(gkey, None)
                nops += len(records) - 1  # +1 below, like a plain op
            else:
                try:
                    op, key, value = decode_op(payload)
                except (ValueError, struct.error):
                    break
                if op == OP_SET:
                    state[key] = value
                elif op == OP_DELETE:
                    state.pop(key, None)
                else:
                    break
            valid_len = end
            nops += 1
        return state, valid_len, nops

    # -- append path ---------------------------------------------------

    def _open_journal_locked(self, gen: int) -> None:
        self._fh = open(self._journal_path(gen), "ab")
        if self._fh.tell() == 0:
            self._fh.write(pack_frame(JOURNAL_MAGIC))
            self._sync_locked()

    def _sync_locked(self) -> float:
        """Flush (+ fsync under the default policy); returns the fsync
        wall seconds (0.0 when fsync is off)."""
        self._fh.flush()
        if not self._fsync:
            return 0.0
        t0 = time.monotonic_ns()
        os.fsync(self._fh.fileno())
        return (time.monotonic_ns() - t0) / 1e9

    def _record_append(self, fsync_s: float) -> None:
        """The JR_FSYNC span of one append, written after ``_lock`` is
        released (it stays a leaf)."""
        tr = self._trace
        if tr is not None and fsync_s > 0.0 \
                and timeline_mod.CONTROL_PLANE_ENABLED:
            tr.span_since("journal", "JR_FSYNC",
                          time.monotonic_ns() - int(fsync_s * 1e9))

    def append_set(self, key: str, value: bytes) -> None:
        with self._lock:
            if self._fh is None:
                return  # closed (server shutdown race): drop silently
            self._fh.write(pack_frame(encode_op(OP_SET, key, value)))
            fsync_s = self._sync_locked()
            self._ops_since_snap += 1
        self._record_append(fsync_s)

    def append_delete(self, key: str) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(pack_frame(encode_op(OP_DELETE, key)))
            fsync_s = self._sync_locked()
            self._ops_since_snap += 1
        self._record_append(fsync_s)

    def append_group(self, records: List[Tuple[int, str, bytes]]) -> None:
        """Append a batched transaction as ONE frame (one write, one
        fsync): the whole group replays or none of it does.  ``records``
        are (OP_SET/OP_DELETE, key, value) tuples in apply order."""
        if not records:
            return
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(pack_frame(encode_group(records)))
            fsync_s = self._sync_locked()
            self._ops_since_snap += len(records)
        self._record_append(fsync_s)

    def maybe_compact(self, state: Dict[str, bytes]) -> bool:
        """Compact when the op budget is spent; ``state`` is the full
        post-op KV map (the caller holds the store lock, so it cannot
        move underneath).  Returns whether a compaction ran."""
        t0 = time.monotonic_ns()
        with self._lock:
            if self._fh is None or \
                    self._ops_since_snap < self._snapshot_every:
                return False
            self._compact_locked(state)
        if self._trace is not None and timeline_mod.CONTROL_PLANE_ENABLED:
            self._trace.span_since("journal", "JR_COMPACT", t0,
                                   {"generation": self._gen})
        return True

    def _compact_locked(self, state: Dict[str, bytes]) -> None:
        new_gen = self._gen + 1
        snap = self._snap_path(new_gen)
        tmp = snap + ".tmp"
        with open(tmp, "wb") as f:
            f.write(pack_frame(SNAP_MAGIC))
            for key in sorted(state):
                f.write(pack_frame(encode_op(OP_SET, key, state[key])))
            f.write(pack_frame(SNAP_END))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap)
        self._fsync_dir()
        # Publish point passed: switch journals, then prune generations
        # older than the one we just superseded (keep 2: a torn NEW
        # snapshot must still find a complete predecessor).
        self._fh.close()
        self._gen = new_gen
        self._open_journal_locked(new_gen)
        self._ops_since_snap = 0
        for gen in self._generations():
            if gen < new_gen - 1:
                for path in (self._snap_path(gen), self._journal_path(gen)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        log.debug("compacted rendezvous journal to generation %d "
                  "(%d keys)", new_gen, len(state))

    def _fsync_dir(self) -> None:
        """Make the rename durable (POSIX: the directory entry needs its
        own fsync); best-effort on filesystems without directory fds."""
        try:
            fd = os.open(self._dir, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._sync_locked()
                    self._fh.close()
                finally:
                    self._fh = None
