"""The rendezvous server: a threaded HTTP key-value store.

The port's copy of ``horovod_tpu/runner/rendezvous.py`` (reference
``horovod/runner/http/http_server.py``).  The launcher starts one before
it spawns the workers (:class:`RendezvousServer`), or attaches to one that
a supervisor runs (:class:`ExternalRendezvous`,
``HOROVOD_RENDEZVOUS_EXTERNAL=host:port``).  It holds the job's durable
scopes (``transport/scopes.py``): the elastic driver's epoch and slot
table, the workers' acks, leases, notify addresses, reset requests and
demotion reports, the reshard marker and commit.

- ``PUT``/``GET``/``DELETE /scope/key`` and ``POST /batch`` (an ordered op
  list under one lock, journaled as one record group), each signed with
  the job's key (``common/secret.py``) when the server holds one;
  ``HOROVOD_RENDEZVOUS_BATCH=0`` answers ``POST /batch`` with 404, and the
  clients fall back to one request per op.
- ``GET /__keys__/<scope>`` lists a scope (signed: the list tells who is
  in the job).
- ``GET /clock``: the server's wall clock in ns, unsigned and read-only,
  from which every process estimates its offset for ``trace_merge``
  (``core/timeline.py::estimate_server_clock_offset_ns``).
- ``GET /metrics`` answers 404: the cluster's metrics view comes with
  ROADMAP A7.

With a journal directory (``HOROVOD_RENDEZVOUS_JOURNAL_DIR`` or
``--journal-dir``), every mutation is written ahead to
``transport/journal.py``'s journal, so that a server SIGKILLed mid-job
and started again over the same directory, on the same port, replays to
its state before the kill.  Run the supervised deployment with::

    HOROVOD_SECRET_KEY=<the job's key> \\
        python -m horovod_tpu_torch.runner.rendezvous --port 7010 \\
        --journal-dir /var/lib/hvd/rendezvous

``GET`` requests pass the ``store.get_serve`` fault site
(``common/faults.py``).  With ``HOROVOD_SERVER_TIMELINE`` (or ``--trace``)
the server writes its own trace: an ``RV_<OP>`` span per request, the
store lock's ``RV_LOCK_WAIT`` and the journal's ``JR_FSYNC``,
``JR_COMPACT`` and ``JR_REPLAY``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import unquote

from ..common import env as env_mod
from ..common import faults
from ..common import secret as secret_mod
from ..core import timeline as timeline_mod
from ..transport.store import (
    BATCH_PATH,
    KEYS_PSEUDO_SCOPE,
    DurableMemoryStore,
    HTTPStoreClient,
    decode_batch_ops,
    encode_batch_results,
)

_METRICS_404 = (b"GET /metrics: the cluster's metrics view is not ported "
                b"yet (ROADMAP A7, the metrics export)")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # The status line and the body leave as two small sends: without this,
    # Nagle holds the second until the client's delayed ACK (~40 ms).
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _span(self, t0_ns: int, op: str, scope: str) -> None:
        """The request's ``RV_<OP>`` span on the server's trace."""
        tl = self.server.timeline
        if tl is not None and timeline_mod.CONTROL_PLANE_ENABLED:
            tl.span_since(f"rv_{op}", "RV_" + op.upper(), t0_ns,
                          {"scope": scope})

    def _parse(self) -> Optional[Tuple[str, str]]:
        parts = [unquote(p) for p in self.path.split("/") if p]
        if len(parts) != 2:
            self.send_error(400, "expected /scope/key")
            return None
        return parts[0], parts[1]

    def _authorized(self, body: bytes) -> bool:
        """With a job key, every request must carry a valid signature:
        otherwise any peer on the network could rewrite the slot table."""
        secret = self.server.job_secret
        if secret is None:
            return True
        ok = secret_mod.verify(secret, self.command, self.path, body,
                               self.headers.get(secret_mod.SIG_HEADER))
        if not ok:
            self.send_error(403, "bad or missing request signature")
        return ok

    def _reply(self, body: bytes, content_type: str,
               status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        t0 = time.monotonic_ns()
        scope = "?"
        try:
            parsed = self._parse()
            if parsed is None:
                return
            scope, key = parsed
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if not self._authorized(body):
                return
            self.server.store.set(scope, key, body)
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()
        finally:
            self._span(t0, "put", scope)

    def do_GET(self):
        if faults.ACTIVE:
            faults.inject("store.get_serve")
        t0 = time.monotonic_ns()
        op, scope = "get", "?"
        try:
            path = self.path.partition("?")[0]
            if path == "/clock":
                op, scope = "clock", "-"
                self._reply(str(time.time_ns()).encode(), "text/plain")
                return
            if path == "/metrics":
                op, scope = "metrics", "-"
                self._reply(_METRICS_404, "text/plain", status=404)
                return
            parsed = self._parse()
            if parsed is None:
                return
            scope, key = parsed
            if not self._authorized(b""):
                return
            if scope == KEYS_PSEUDO_SCOPE:
                op, scope = "keys", key
                self._reply(json.dumps(sorted(
                    self.server.store.keys(key))).encode(),
                    "application/json")
                return
            val = self.server.store.get(scope, key)
            if val is None:
                self.send_error(404, "no such key")
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(val)))
            self.end_headers()
            self.wfile.write(val)
        finally:
            self._span(t0, op, scope)

    def do_DELETE(self):
        t0 = time.monotonic_ns()
        scope = "?"
        try:
            parsed = self._parse()
            if parsed is None:
                return
            scope, key = parsed
            if not self._authorized(b""):
                return
            existed = self.server.store.pop(scope, key) is not None
            self.send_response(200 if existed else 404)
            self.send_header("Content-Length", "0")
            self.end_headers()
        finally:
            self._span(t0, "delete", scope)

    def do_POST(self):
        """``POST /batch``: one signed, ordered op list, applied under one
        lock and journaled as one record group; the reply holds each op's
        result.  404 when batching is off on this server."""
        t0 = time.monotonic_ns()
        try:
            # Read the body before any error reply: on a keep-alive
            # connection it would otherwise be read as the next request.
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            if self.path.partition("?")[0] != BATCH_PATH \
                    or not self.server.batch_enabled:
                self.send_error(404, "no such endpoint")
                return
            if not self._authorized(body):
                return
            try:
                ops = decode_batch_ops(body)
            except (ValueError, KeyError, TypeError):
                self.send_error(400, "malformed batch body")
                return
            results = self.server.store.batch(ops)
            self._reply(encode_batch_results(results), "application/json")
        finally:
            self._span(t0, "batch", "-")


class _KVServer(ThreadingHTTPServer):
    daemon_threads = True
    # A restarted server binds the port that the job already holds.
    allow_reuse_address = True
    # The default backlog of 5 resets connections when a whole job's
    # workers rendezvous at once.
    request_queue_size = 128

    def __init__(self, addr, job_secret=None, journal_dir=None,
                 timeline=None):
        super().__init__(addr, _Handler)
        self.store = DurableMemoryStore(journal_dir, timeline=timeline)
        self.store.enable_observability(timeline)
        self.job_secret = job_secret
        self.timeline = timeline
        self.batch_enabled = env_mod.get_bool(
            env_mod.HOROVOD_RENDEZVOUS_BATCH, True)

    def server_close(self):
        super().server_close()
        self.store.close()


class RendezvousServer:
    """The server in this process; :meth:`start` returns the bound port.
    The elastic driver calls its store surface (``set``, ``get``,
    ``delete``, ``keys``, ``batch``) directly, without HTTP."""

    def __init__(self, bind_addr: str = "0.0.0.0",
                 job_secret: Optional[bytes] = None,
                 journal_dir: Optional[str] = None,
                 trace_path: Optional[str] = None):
        self._bind_addr = bind_addr
        self._server: Optional[_KVServer] = None
        self._thread: Optional[threading.Thread] = None
        self._job_secret = job_secret
        if journal_dir is None:
            journal_dir = env_mod.get_str(
                env_mod.HOROVOD_RENDEZVOUS_JOURNAL_DIR) or None
        self._journal_dir = journal_dir
        if trace_path is None:
            trace_path = env_mod.get_str(
                env_mod.HOROVOD_SERVER_TIMELINE) or None
        self._trace_path = trace_path
        self._timeline = None

    def start(self, port: int = 0) -> int:
        if self._trace_path:
            # The server's clock is trace_merge's base: offset 0.  Not the
            # process's active timeline: in the launcher, the driver's is.
            self._timeline = timeline_mod.Timeline(
                self._trace_path, rank=timeline_mod.SERVER_TRACE_PID,
                clock_offset_ns=0, activate=False,
                process_name="rendezvous server")
        self._server = _KVServer((self._bind_addr, port),
                                 job_secret=self._job_secret,
                                 journal_dir=self._journal_dir,
                                 timeline=self._timeline)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="rendezvous-http",
            daemon=True)
        self._thread.start()
        return self._server.server_address[1]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def set(self, scope: str, key: str, value: bytes) -> None:
        self._server.store.set(scope, key, value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self._server.store.get(scope, key)

    def delete(self, scope: str, key: str) -> None:
        self._server.store.delete(scope, key)

    def keys(self, scope: str) -> List[str]:
        return self._server.store.keys(scope)

    def batch(self, ops: List[tuple]) -> List[object]:
        return self._server.store.batch(ops)

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._timeline is not None:
            self._timeline.close()
            self._timeline = None


class ExternalRendezvous:
    """The same surface as :class:`RendezvousServer` for a server in
    another process (``HOROVOD_RENDEZVOUS_EXTERNAL=host:port``), over the
    signed HTTP client.  Its ops can fail with ``OSError``, which is what
    puts the elastic driver in its store-outage mode.  ``stop()`` leaves
    the server alone: its supervisor owns it, and it outlives the
    launcher."""

    def __init__(self, addr: str, port: int):
        self.addr = addr
        self._port = int(port)
        self._client = HTTPStoreClient(addr, self._port)

    @classmethod
    def from_env(cls, value: str) -> "ExternalRendezvous":
        """From ``HOROVOD_RENDEZVOUS_EXTERNAL``'s ``host:port``."""
        host, _, port = value.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(
                f"launch: {env_mod.HOROVOD_RENDEZVOUS_EXTERNAL} must be "
                f"host:port, got {value!r}")
        return cls(host, int(port))

    @property
    def port(self) -> int:
        return self._port

    def set(self, scope: str, key: str, value: bytes) -> None:
        self._client.set(scope, key, value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        return self._client.get(scope, key)

    def delete(self, scope: str, key: str) -> None:
        self._client.delete(scope, key)

    def keys(self, scope: str) -> List[str]:
        return self._client.keys(scope)

    def batch(self, ops: List[tuple]) -> List[object]:
        return self._client.batch(ops)

    def stop(self) -> None:
        pass


def main(argv: Optional[List[str]] = None) -> int:
    """The supervised server: serves until SIGTERM or SIGINT."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.rendezvous",
        description="the journaled rendezvous key-value server")
    parser.add_argument("--bind", default="0.0.0.0",
                        help="address to bind (default 0.0.0.0)")
    parser.add_argument("--port", type=int, default=0,
                        help="port to bind (default: any free one, printed)")
    parser.add_argument("--journal-dir", default=None,
                        help="journal and snapshot directory (default: "
                             "HOROVOD_RENDEZVOUS_JOURNAL_DIR; unset: no "
                             "journal)")
    parser.add_argument("--trace", default=None,
                        help="write the server's own trace here (default: "
                             "HOROVOD_SERVER_TIMELINE)")
    args = parser.parse_args(argv)

    server = RendezvousServer(bind_addr=args.bind,
                              job_secret=secret_mod.job_secret(),
                              journal_dir=args.journal_dir,
                              trace_path=args.trace)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    port = server.start(args.port)
    print(f"rendezvous serving on port {port}", flush=True)
    try:
        while not stop.wait(1.0):
            pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
