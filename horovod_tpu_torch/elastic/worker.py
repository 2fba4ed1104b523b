"""Driver <-> worker notification channel.

The port's copy of ``horovod_tpu/elastic/worker.py`` (reference
``runner/elastic/worker.py:1-110``): each worker runs a small HTTP server
whose address it registers in the store's ``workers`` scope; the driver
POSTs to it when the host set changes, with the new epoch, and the worker
raises ``HostsUpdatedInterrupt`` at its next ``state.commit()``.  Every
ping is signed with the job's key (``common/secret.py``).  A ping marked
``reshard=1`` also aborts the runtime's in-flight host-plane collectives
(``core/state.py::abort_for_reshard``).
"""

from __future__ import annotations

import socket
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from ..common import env as env_mod
from ..common import secret as secret_mod
from ..common.logging_util import get_logger
from ..transport.scopes import WORKERS_SCOPE
from .rendezvous_client import identity, store_client

log = get_logger("horovod_tpu_torch.elastic.worker")


class _NotifyHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def do_POST(self):
        from ..core.state import abort_for_reshard
        from .state import notify_hosts_updated

        secret = secret_mod.job_secret()
        if secret is not None and not secret_mod.verify(
                secret, self.command, self.path, b"",
                self.headers.get(secret_mod.SIG_HEADER)):
            self.send_error(403, "bad or missing request signature")
            return
        parsed = urlparse(self.path)
        added_only = parsed.path.rstrip("/").endswith("added")
        query = parse_qs(parsed.query)
        epoch = int(query["epoch"][0]) if "epoch" in query else None
        notify_hosts_updated(added_only=added_only, epoch=epoch)
        if query.get("reshard") == ["1"]:
            # Epoch-filtered inside: a stale ping must not abort the world
            # this worker already runs in.
            abort_for_reshard(epoch)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


def _local_job() -> bool:
    return env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR).startswith("127.")


def start_notification_service() -> int:
    """Start this worker's notify server and register its address in the
    rendezvous server; returns the bound port."""
    local = _local_job()
    server = ThreadingHTTPServer(("127.0.0.1" if local else "0.0.0.0", 0),
                                 _NotifyHandler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="hvd-elastic-notify").start()
    port = server.server_address[1]
    store = store_client()
    if store is None:
        return port

    addr = "127.0.0.1" if local else \
        socket.gethostbyname(socket.gethostname())
    store.set(WORKERS_SCOPE, identity(), f"{addr}:{port}".encode())
    return port


class WorkerNotificationClient:
    """Driver side: ping registered workers about a host change."""

    def __init__(self, addresses: List[str]):
        self._addresses = addresses

    def notify_hosts_updated(self, added_only: bool,
                             epoch: Optional[int] = None,
                             reshard: bool = False) -> None:
        suffix = "added" if added_only else "changed"
        query = f"?epoch={epoch}" if epoch is not None else ""
        if reshard:
            query += ("&" if query else "?") + "reshard=1"
        path = f"/notify/{suffix}{query}"
        secret = secret_mod.job_secret()
        # The workers are reached directly, never through a proxy that the
        # environment may name.
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        for addr in self._addresses:
            try:
                req = urllib.request.Request(f"http://{addr}{path}", data=b"",
                                             method="POST")
                if secret is not None:
                    req.add_header(secret_mod.SIG_HEADER,
                                   secret_mod.sign(secret, "POST", path, b""))
                with opener.open(req, timeout=5):
                    pass
            except OSError as e:
                log.debug("worker notify %s failed: %s", addr, e)
