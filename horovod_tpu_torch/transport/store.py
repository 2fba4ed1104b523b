"""The rendezvous store: a key-value store by scope and key, with blocking
waits.

Counterpart of ``horovod_tpu/transport/store.py:237-313`` (``Store``:
``set``, ``get``, ``wait``), over ``torch.distributed.TCPStore`` instead of
the JAX package's HTTP server: the launcher hosts the server
(:class:`StoreServer`), every worker connects a client (:meth:`Store.connect`),
and the process groups rendezvous through it under epoch-scoped prefixes
(:meth:`Store.group_store`), as Horovod's own GlooController does.  The
HTTP server's journal and the elastic membership wait for the elastic slice.
"""

from __future__ import annotations

import datetime
import socket
from typing import Dict, List, Optional

import torch.distributed as dist


def _timedelta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


class Store:
    """Scope-prefixed keys (``<scope>/<key>``) over one ``TCPStore``."""

    def __init__(self, tcp_store: "dist.TCPStore"):
        self.tcp = tcp_store

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
        self.tcp.set(self._key(scope, key), value)

    def get(self, scope: str, key: str) -> Optional[bytes]:
        """Non-blocking read; None when absent."""
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
        self.store = Store(self.tcp)

    def close(self) -> None:
        self.store = None
        self.tcp = None
