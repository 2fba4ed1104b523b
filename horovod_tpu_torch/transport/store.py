"""The rendezvous stores: key-value stores by scope and key.

Counterpart of ``horovod_tpu/transport/store.py``.  Two kinds of store
serve a job:

- The HTTP rendezvous store, as in the JAX package: :class:`MemoryStore`
  and :class:`DurableMemoryStore` (the same, with the write-ahead journal
  of ``transport/journal.py``) behind the server of
  ``runner/rendezvous.py``, and :class:`HTTPStoreClient`, its client.
  They hold the job's durable scopes: the elastic driver's epoch and slot
  table, the acks, leases, reset requests, demotion reports, the workers'
  notify addresses, the reshard marker and commit.  An ordered batch of
  ``set``/``get``/``check``/``delete``/``keys`` ops goes in one ``POST
  /batch`` and is applied under one lock and journaled as one record group
  (:func:`batch_steps`, the JAX package's generator; the wire codec is the
  JAX package's, so either package's client talks to either server).
- :class:`Store` over ``torch.distributed.TCPStore``, which the launcher
  hosts (:class:`StoreServer`): the process groups rendezvous through it
  under epoch-scoped prefixes (:meth:`Store.group_store`) and the ranks
  post their cards there, which needs c10d's blocking ``wait``.  Its keys
  are needed only while an epoch's groups are built.

The clients' ``set`` and ``batch`` are the ``store.put`` fault site and
their ``get`` is ``rendezvous.get`` (``common/faults.py``), where the JAX
package's HTTP client has them; the launcher's own handles inject nothing.
"""

from __future__ import annotations

import base64
import datetime
import http.client
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from ..common import env as env_mod
from ..common import faults
from ..common import secret as secret_mod
from ..core import timeline as timeline_mod

#: The server's scope listing, ``GET /__keys__/<scope>`` (a JSON list).
KEYS_PSEUDO_SCOPE = "__keys__"

#: Batched transactions: ``POST /batch`` carries an ordered op list.
BATCH_PATH = "/batch"

#: Overlay marker for a key deleted earlier in the same batch.
_TOMBSTONE = object()


# -- the batch, as a pure generator (the JAX package's, unchanged) -----------
#
# Every state access is one yielded step, in program order; the caller
# executes it against the live dict and journal.  Steps:
#
#   (STEP_LOAD, flat)             -> Optional[bytes]   read one key
#   (STEP_KEYS, prefix)           -> List[str]         flat keys w/ prefix
#   (STEP_JOURNAL, mutations)                          append the group
#                                    record (one frame) BEFORE any apply
#   (STEP_APPLY, flat, value)                          apply one mutation
#                                    (value None = delete)
#   (STEP_NOTIFY,)                                     wake blocked waiters
#   (STEP_REPLY, results)                              the ack point
#
# The generator returns the results list.

STEP_LOAD = "load"
STEP_KEYS = "keys"
STEP_JOURNAL = "journal_append"
STEP_APPLY = "store_apply"
STEP_NOTIFY = "notify"
STEP_REPLY = "reply"


def batch_steps(ops: List[tuple]):
    """Evaluate one ordered batch: stage the mutations in an overlay (later
    ops read the batch's own writes), journal the whole group as one
    record, then apply; the journal comes strictly before the first apply
    and the reply strictly after the last.  A crash at any step and the
    journal's truncating replay keep the group atomic.

    ``("check", scope, key, expected)`` guards the whole batch: when the
    key's value (``expected=None``: absent) does not match, nothing is
    journaled or applied and the reply ends with ``False`` at the check's
    position.  The elastic driver's initial publish fences on it."""
    from .journal import OP_DELETE, OP_SET

    overlay: Dict[str, object] = {}
    mutations: List[Tuple[int, str, bytes]] = []
    results: List[object] = []
    any_set = False
    for op in ops:
        kind = op[0]
        if kind == "check":
            _, scope, key, expected = op
            flat = f"{scope}/{key}"
            if flat in overlay:
                v = overlay[flat]
                actual = None if v is _TOMBSTONE else v
            else:
                actual = yield (STEP_LOAD, flat)
            if actual != expected:
                yield (STEP_REPLY, tuple(results) + (False,))
                return results + [False]
            results.append(True)
        elif kind == "set":
            _, scope, key, value = op
            flat = f"{scope}/{key}"
            overlay[flat] = value
            mutations.append((OP_SET, flat, value))
            results.append(True)
            any_set = True
        elif kind == "get":
            flat = f"{op[1]}/{op[2]}"
            if flat in overlay:
                v = overlay[flat]
                results.append(None if v is _TOMBSTONE else v)
            else:
                results.append((yield (STEP_LOAD, flat)))
        elif kind == "delete":
            flat = f"{op[1]}/{op[2]}"
            if flat in overlay:
                existed = overlay[flat] is not _TOMBSTONE
            else:
                existed = (yield (STEP_LOAD, flat)) is not None
            if existed:  # no journal record for a no-op delete
                overlay[flat] = _TOMBSTONE
                mutations.append((OP_DELETE, flat, b""))
            results.append(existed)
        elif kind == "keys":
            prefix = f"{op[1]}/"
            base = yield (STEP_KEYS, prefix)
            names = {k[len(prefix):] for k in base}
            for flat, v in overlay.items():
                if flat.startswith(prefix):
                    if v is _TOMBSTONE:
                        names.discard(flat[len(prefix):])
                    else:
                        names.add(flat[len(prefix):])
            results.append(sorted(names))
        else:
            raise ValueError(f"unknown batch op {kind!r}")
    yield (STEP_JOURNAL, tuple(mutations))
    for flat, v in overlay.items():
        yield (STEP_APPLY, flat, None if v is _TOMBSTONE else v)
    if any_set:
        yield (STEP_NOTIFY,)
    yield (STEP_REPLY, tuple(results))
    return results


# -- the batch's wire codec: JSON with base64 values, signed like every op --

def encode_batch_ops(ops: List[tuple]) -> bytes:
    """Serialize an ordered op list — ``("set", scope, key, value)`` /
    ``("get", scope, key)`` / ``("delete", scope, key)`` /
    ``("keys", scope)`` — into one request body."""
    out = []
    for op in ops:
        kind = op[0]
        if kind == "set":
            out.append({"op": "set", "scope": op[1], "key": op[2],
                        "value": base64.b64encode(op[3]).decode("ascii")})
        elif kind == "check":
            item = {"op": "check", "scope": op[1], "key": op[2]}
            if op[3] is not None:  # absent "value" = key must not exist
                item["value"] = base64.b64encode(op[3]).decode("ascii")
            out.append(item)
        elif kind in ("get", "delete"):
            out.append({"op": kind, "scope": op[1], "key": op[2]})
        elif kind == "keys":
            out.append({"op": "keys", "scope": op[1]})
        else:
            raise ValueError(f"unknown batch op {kind!r}")
    return json.dumps({"ops": out}).encode()


def decode_batch_ops(body: bytes) -> List[tuple]:
    doc = json.loads(body.decode())
    ops: List[tuple] = []
    for item in doc["ops"]:
        kind = item["op"]
        if kind == "set":
            ops.append(("set", item["scope"], item["key"],
                        base64.b64decode(item["value"])))
        elif kind == "check":
            expected = base64.b64decode(item["value"]) \
                if "value" in item else None
            ops.append(("check", item["scope"], item["key"], expected))
        elif kind in ("get", "delete"):
            ops.append((kind, item["scope"], item["key"]))
        elif kind == "keys":
            ops.append(("keys", item["scope"]))
        else:
            raise ValueError(f"unknown batch op {kind!r}")
    return ops


def encode_batch_results(results: List[object]) -> bytes:
    """Per-op results, positionally aligned with the request's op list:
    set → True, get → bytes or None, delete → existed bool, keys →
    sorted name list.  bytes ride base64 under a distinct wrapper key so
    a JSON ``null`` get-result stays distinguishable."""
    out = []
    for r in results:
        if isinstance(r, bytes):
            out.append({"b64": base64.b64encode(r).decode("ascii")})
        else:
            out.append({"v": r})
    return json.dumps({"results": out}).encode()


def decode_batch_results(body: bytes) -> List[object]:
    out: List[object] = []
    for item in json.loads(body.decode())["results"]:
        if "b64" in item:
            out.append(base64.b64decode(item["b64"]))
        else:
            out.append(item["v"])
    return out


class KVStore:
    """A scope-prefixed key-value store (the JAX package's ``Store``)."""

    def set(self, scope: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, scope: str, key: str) -> Optional[bytes]:
        """Non-blocking read; None when absent."""
        raise NotImplementedError

    def delete(self, scope: str, key: str) -> None:
        raise NotImplementedError

    def keys(self, scope: str) -> List[str]:
        raise NotImplementedError

    def batch(self, ops: List[tuple]) -> List[object]:
        """An ordered op list; the results align with ``ops`` (set -> True,
        get -> bytes or None, check -> bool, delete -> whether the key
        existed, keys -> the names).  This base runs one op at a time: the
        path of a client whose server has batching off, with no atomicity,
        but nothing after a failed check runs."""
        results: List[object] = []
        for op in ops:
            kind = op[0]
            if kind == "check":
                if self.get(op[1], op[2]) != op[3]:
                    results.append(False)
                    return results
                results.append(True)
            elif kind == "set":
                self.set(op[1], op[2], op[3])
                results.append(True)
            elif kind == "get":
                results.append(self.get(op[1], op[2]))
            elif kind == "delete":
                existed = self.get(op[1], op[2]) is not None
                self.delete(op[1], op[2])
                results.append(existed)
            elif kind == "keys":
                results.append(self.keys(op[1]))
            else:
                raise ValueError(f"unknown batch op {kind!r}")
        return results

    def wait(self, scope: str, keys: List[str],
             timeout: float = 60.0) -> Dict[str, bytes]:
        """Poll until every key exists; returns the values."""
        deadline = time.monotonic() + timeout
        out: Dict[str, bytes] = {}
        pending = list(keys)
        while pending:
            still = []
            for k in pending:
                v = self.get(scope, k)
                if v is None:
                    still.append(k)
                else:
                    out[k] = v
            pending = still
            if pending:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"store wait timed out after {timeout}s for keys "
                        f"{pending} in scope {scope!r}")
                time.sleep(0.01)
        return out


class MemoryStore(KVStore):
    """The store in one process: the rendezvous server's, and the tests'."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._cv = threading.Condition()
        # The server's trace, for RV_LOCK_WAIT spans (enable_observability).
        self._trace = None

    def enable_observability(self, trace=None) -> None:
        self._trace = trace

    def _acquire(self) -> None:
        """Take the store's lock; with a server trace, a wait of 50 us or
        more becomes an RV_LOCK_WAIT span (shorter ones would flood the
        trace, and they lie inside the request's RV_* span anyway).  Pair
        with ``self._cv.release()``."""
        tr = self._trace
        if tr is None or not timeline_mod.CONTROL_PLANE_ENABLED:
            self._cv.acquire()
            return
        t0 = time.monotonic_ns()
        self._cv.acquire()
        if time.monotonic_ns() - t0 >= 50_000:
            tr.span_since("store_lock", "RV_LOCK_WAIT", t0)

    def set(self, scope: str, key: str, value: bytes) -> None:
        self._acquire()
        try:
            self._data[f"{scope}/{key}"] = value
            self._cv.notify_all()
        finally:
            self._cv.release()

    def get(self, scope: str, key: str) -> Optional[bytes]:
        self._acquire()
        try:
            return self._data.get(f"{scope}/{key}")
        finally:
            self._cv.release()

    def delete(self, scope: str, key: str) -> None:
        self.pop(scope, key)

    def pop(self, scope: str, key: str) -> Optional[bytes]:
        """Delete under one lock, returning the value (None when absent)."""
        self._acquire()
        try:
            return self._data.pop(f"{scope}/{key}", None)
        finally:
            self._cv.release()

    def keys(self, scope: str) -> List[str]:
        prefix = f"{scope}/"
        self._acquire()
        try:
            return [k[len(prefix):] for k in self._data
                    if k.startswith(prefix)]
        finally:
            self._cv.release()

    def batch(self, ops: List[tuple]) -> List[object]:
        """The whole op list under one lock: :func:`batch_steps` executed
        against the dict and, in :class:`DurableMemoryStore`, the journal
        (the group record is written before the first apply)."""
        self._acquire()
        try:
            data = self._data
            steps = batch_steps(ops)
            resp = None
            while True:
                try:
                    step = steps.send(resp)
                except StopIteration as fin:
                    results = fin.value
                    break
                kind = step[0]
                resp = None
                if kind == STEP_LOAD:
                    resp = data.get(step[1])
                elif kind == STEP_KEYS:
                    prefix = step[1]
                    resp = [k for k in data if k.startswith(prefix)]
                elif kind == STEP_JOURNAL:
                    self._journal_group(list(step[1]))
                elif kind == STEP_APPLY:
                    _, flat, v = step
                    if v is None:
                        data.pop(flat, None)
                    else:
                        data[flat] = v
                elif kind == STEP_NOTIFY:
                    self._cv.notify_all()
                # STEP_REPLY: returning is the reply, after journal and apply.
            self._after_batch_locked()
            return list(results)
        finally:
            self._cv.release()

    def _journal_group(self, mutations: List[Tuple[int, str, bytes]]
                       ) -> None:
        """Called under the lock before a batch's mutations apply; a plain
        MemoryStore has no journal."""

    def _after_batch_locked(self) -> None:
        """Called under the lock after a batch applied."""


class DurableMemoryStore(MemoryStore):
    """A :class:`MemoryStore` whose mutations go through the write-ahead
    journal of ``transport/journal.py`` before they apply, so that a store
    built again over the same ``journal_dir`` (after a SIGKILL) replays to
    every acknowledged write.  ``journal_dir=None`` is a plain
    MemoryStore.  The journal's lock is taken under the store's, never the
    other way round."""

    def __init__(self, journal_dir: Optional[str] = None,
                 fsync: Optional[bool] = None,
                 snapshot_every: Optional[int] = None,
                 timeline=None):
        super().__init__()
        self._journal = None
        if not journal_dir:
            return
        from .journal import StoreJournal

        if fsync is None:
            fsync = env_mod.get_bool(
                env_mod.HOROVOD_RENDEZVOUS_JOURNAL_FSYNC, True)
        if snapshot_every is None:
            snapshot_every = env_mod.get_int(
                env_mod.HOROVOD_RENDEZVOUS_SNAPSHOT_EVERY,
                env_mod.DEFAULT_RENDEZVOUS_SNAPSHOT_EVERY)
        self._journal = StoreJournal(journal_dir, fsync=fsync,
                                     snapshot_every=snapshot_every,
                                     trace=timeline)
        recovered = self._journal.recover()
        with self._cv:
            self._data.update(recovered)

    def set(self, scope: str, key: str, value: bytes) -> None:
        if self._journal is None:
            return super().set(scope, key, value)
        self._acquire()
        try:
            flat = f"{scope}/{key}"
            self._journal.append_set(flat, value)
            self._data[flat] = value
            self._journal.maybe_compact(self._data)
            self._cv.notify_all()
        finally:
            self._cv.release()

    def pop(self, scope: str, key: str) -> Optional[bytes]:
        if self._journal is None:
            return super().pop(scope, key)
        self._acquire()
        try:
            flat = f"{scope}/{key}"
            if flat not in self._data:
                return None  # no journal record for a no-op delete
            self._journal.append_delete(flat)
            value = self._data.pop(flat)
            self._journal.maybe_compact(self._data)
            return value
        finally:
            self._cv.release()

    def _journal_group(self, mutations) -> None:
        if self._journal is not None:
            self._journal.append_group(mutations)

    def _after_batch_locked(self) -> None:
        if self._journal is not None:
            self._journal.maybe_compact(self._data)

    def close(self) -> None:
        if self._journal is not None:
            self._journal.close()


class HTTPStoreClient(KVStore):
    """Client of the rendezvous server (``runner/rendezvous.py``): ``PUT
    /scope/key`` stores the body, ``GET /scope/key`` answers 200 and the
    value or 404, ``DELETE /scope/key`` removes, ``GET /__keys__/scope``
    lists, ``POST /batch`` runs an op list.  Every request is signed with
    the job's key when there is one (``common/secret.py``).  A refused or
    reset connection is retried a few times (the ops are idempotent); then
    the error (an ``OSError``) reaches the caller, which is how the
    elastic driver and the lease renewals see an outage."""

    def __init__(self, addr: str, port: int, timeout: float = 30.0):
        self._base = f"http://{addr}:{port}"
        self._addr = addr
        self._port = port
        self._timeout = timeout
        # One keep-alive connection per thread for the batches (http.client
        # connections are not thread-safe).
        self._conn_local = threading.local()
        self._secret = secret_mod.job_secret()
        # Never through a proxy: the server is the job's own.
        self._opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}))
        self._batch_enabled = env_mod.get_bool(
            env_mod.HOROVOD_RENDEZVOUS_BATCH, True)
        self._batch_max_ops = max(1, env_mod.get_int(
            env_mod.HOROVOD_RENDEZVOUS_BATCH_MAX_OPS,
            env_mod.DEFAULT_RENDEZVOUS_BATCH_MAX_OPS))
        # Set by the first 404/501 to a POST /batch: the server has
        # batching off, and this client goes one op at a time from then on.
        self._batch_unsupported = False

    def _request(self, scope: str, key: str, method: str,
                 data: Optional[bytes] = None) -> urllib.request.Request:
        path = f"/{urllib.parse.quote(scope)}/{urllib.parse.quote(key)}"
        req = urllib.request.Request(self._base + path, data=data,
                                     method=method)
        if self._secret is not None:
            req.add_header(secret_mod.SIG_HEADER, secret_mod.sign(
                self._secret, method, path, data or b""))
        return req

    def _keepalive_post(self, path: str, body: bytes) -> bytes:
        """A signed POST over this thread's persistent connection.  A
        non-200 status is the server's answer (raised as ``HTTPError``); a
        stale or reset connection reconnects and sends again."""
        headers = {}
        if self._secret is not None:
            headers[secret_mod.SIG_HEADER] = secret_mod.sign(
                self._secret, "POST", path, body)
        last: Optional[Exception] = None
        for attempt in range(4):
            conn = getattr(self._conn_local, "conn", None)
            if conn is None:
                conn = http.client.HTTPConnection(
                    self._addr, self._port, timeout=self._timeout)
                self._conn_local.conn = conn
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()  # drained, so the connection is reusable
                if resp.will_close:
                    conn.close()
                    self._conn_local.conn = None
                if resp.status != 200:
                    raise urllib.error.HTTPError(
                        self._base + path, resp.status, resp.reason,
                        resp.headers, io.BytesIO(data))
                return data
            except urllib.error.HTTPError:
                raise
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                self._conn_local.conn = None
                last = e
                time.sleep(0.05 * (attempt + 1))
        raise last

    def _open(self, req: urllib.request.Request):
        """``urlopen`` with the same retries; an HTTP status is an answer
        and is not retried."""
        last: Optional[Exception] = None
        for attempt in range(4):
            try:
                return self._opener.open(req, timeout=self._timeout)
            except urllib.error.HTTPError:
                raise
            except OSError as e:
                last = e
                time.sleep(0.05 * (attempt + 1))
        raise last

    def set(self, scope: str, key: str, value: bytes) -> None:
        if faults.ACTIVE:
            faults.inject("store.put")
        t0 = time.monotonic_ns() if timeline_mod.control_active() else None
        try:
            with self._open(self._request(scope, key, "PUT", value)):
                pass
        finally:
            if t0 is not None:
                timeline_mod.control_span_since(
                    "rendezvous_client", "RVC_SET", t0, scope=scope)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        if faults.ACTIVE:
            faults.inject("rendezvous.get")
        t0 = time.monotonic_ns() if timeline_mod.control_active() else None
        try:
            with self._open(self._request(scope, key, "GET")) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        finally:
            if t0 is not None:
                timeline_mod.control_span_since(
                    "rendezvous_client", "RVC_GET", t0, scope=scope)

    def keys(self, scope: str) -> List[str]:
        t0 = time.monotonic_ns() if timeline_mod.control_active() else None
        try:
            with self._open(self._request(KEYS_PSEUDO_SCOPE, scope,
                                          "GET")) as resp:
                return json.loads(resp.read().decode())
        finally:
            if t0 is not None:
                timeline_mod.control_span_since(
                    "rendezvous_client", "RVC_KEYS", t0, scope=scope)

    def delete(self, scope: str, key: str) -> None:
        t0 = time.monotonic_ns() if timeline_mod.control_active() else None
        try:
            with self._open(self._request(scope, key, "DELETE")):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        finally:
            if t0 is not None:
                timeline_mod.control_span_since(
                    "rendezvous_client", "RVC_DELETE", t0, scope=scope)

    def batch(self, ops: List[tuple]) -> List[object]:
        """One ``POST /batch`` per ``HOROVOD_RENDEZVOUS_BATCH_MAX_OPS`` ops;
        against a server that answers 404 or 501 (batching off), one
        request per op from then on."""
        if not ops:
            return []
        if not self._batch_enabled or self._batch_unsupported:
            return super().batch(ops)
        results: List[object] = []
        for i in range(0, len(ops), self._batch_max_ops):
            chunk = ops[i:i + self._batch_max_ops]
            try:
                part = self._batch_request(chunk)
            except urllib.error.HTTPError as e:
                if e.code not in (404, 501):
                    raise
                self._batch_unsupported = True
                results.extend(super().batch(ops[i:]))
                return results
            results.extend(part)
            if len(part) < len(chunk):
                return results  # a failed check ended the batch
        return results

    def _batch_request(self, chunk: List[tuple]) -> List[object]:
        if faults.ACTIVE:
            faults.inject("store.put")
        t0 = time.monotonic_ns() if timeline_mod.control_active() else None
        try:
            return decode_batch_results(
                self._keepalive_post(BATCH_PATH, encode_batch_ops(chunk)))
        finally:
            if t0 is not None:
                timeline_mod.control_span_since(
                    "rendezvous_client", "RVC_BATCH", t0, ops=len(chunk))


# -- the launcher's TCPStore --------------------------------------------------

def _timedelta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


class Store:
    """Scope-prefixed keys (``<scope>/<key>``) over one ``TCPStore``."""

    def __init__(self, tcp_store: "dist.TCPStore", injects: bool = True):
        self.tcp = tcp_store
        self._injects = injects

    @staticmethod
    def connect(addr: str, port: int, timeout: float) -> "Store":
        """A client of the launcher's server; waits up to ``timeout``
        seconds for it to answer."""
        return Store(dist.TCPStore(addr, port, None, False,
                                   timeout=_timedelta(timeout)))

    @staticmethod
    def _key(scope: str, key: str) -> str:
        return f"{scope}/{key}"

    def set(self, scope: str, key: str, value: bytes) -> None:
        if faults.ACTIVE and self._injects:
            faults.inject("store.put")
        self.tcp.set(self._key(scope, key), value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        """Non-blocking read; None when absent."""
        if faults.ACTIVE and self._injects:
            faults.inject("rendezvous.get")
        k = self._key(scope, key)
        return self.tcp.get(k) if self.tcp.check([k]) else None

    def wait(self, scope: str, keys: List[str],
             timeout: float = 60.0) -> Dict[str, bytes]:
        """Block until every key exists; returns the values."""
        full = [self._key(scope, k) for k in keys]
        try:
            self.tcp.wait(full, _timedelta(timeout))
        except dist.DistStoreError as e:
            missing = [k for k, f in zip(keys, full) if not self.tcp.check([f])]
            raise TimeoutError(
                f"store wait timed out after {timeout}s for keys {missing} "
                f"in scope {scope!r}") from e
        return {k: self.tcp.get(f) for k, f in zip(keys, full)}

    def group_store(self, name: str, epoch: int) -> "dist.PrefixStore":
        """The store a process group rendezvouses through: its keys are
        scoped by the group's name and the membership epoch, so a re-init
        never reads a previous group's entries."""
        return dist.PrefixStore(f"{name}.{epoch}", self.tcp)


class StoreServer:
    """The launcher's server.  ``local_only`` binds it to 127.0.0.1 (every
    slot is on this host); otherwise it listens on every interface."""

    def __init__(self, local_only: bool):
        if local_only:
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            sock.listen(1024)
            port = sock.getsockname()[1]
            # The store takes ownership of the listening socket.
            self.tcp = dist.TCPStore("127.0.0.1", port, None, True,
                                     wait_for_workers=False,
                                     master_listen_fd=sock.detach())
        else:
            self.tcp = dist.TCPStore(socket.gethostname(), 0, None, True,
                                     wait_for_workers=False)
        self.port = self.tcp.port
        self.store = Store(self.tcp, injects=False)

    def close(self) -> None:
        self.store = None
        self.tcp = None
