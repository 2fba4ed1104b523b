"""Per-job secret + HMAC request signing for the service plane.

The port's copy of ``horovod_tpu/common/secret.py``; the elastic driver's
notify pings to the workers (``elastic/worker.py``) are signed with it.

Reference: ``runner/common/util/secret.py:1-36`` (per-job key) and
``runner/common/util/network.py:50-85`` (every RPC carries an HMAC digest
verified before unpickling).  Without this, any LAN peer can rewrite the
rendezvous rank table or forge elastic host-change notifications.

The launcher generates one secret per job and hands it to workers through
``HOROVOD_SECRET_KEY`` (the reference distributes its key the same way —
through the launch environment).  Signing covers ``method|path|body`` of
each HTTP request with HMAC-SHA256.
"""

from __future__ import annotations

import hmac
import hashlib
import secrets as _secrets
from typing import Optional

from . import env as env_mod

SIG_HEADER = "X-Horovod-Sig"


def make_secret() -> str:
    """A fresh per-job key (hex, env-safe)."""
    return _secrets.token_hex(32)


def ensure_job_secret() -> str:
    """Launcher-side bootstrap: reuse HOROVOD_SECRET_KEY if the caller set
    one, else generate — and export it so in-process clients (drivers,
    notification pings) sign consistently with spawned workers."""
    import os

    key = os.environ.get(env_mod.HOROVOD_SECRET_KEY) or make_secret()
    os.environ[env_mod.HOROVOD_SECRET_KEY] = key
    return key


def job_secret() -> Optional[bytes]:
    """The job's key from HOROVOD_SECRET_KEY, or None (unsecured dev runs,
    single-process)."""
    val = env_mod.get_str(env_mod.HOROVOD_SECRET_KEY)
    return val.encode() if val else None


def sign(secret: bytes, method: str, path: str, body: bytes = b"") -> str:
    mac = hmac.new(secret, digestmod=hashlib.sha256)
    mac.update(method.encode())
    mac.update(b"|")
    mac.update(path.encode())
    mac.update(b"|")
    mac.update(body)
    return mac.hexdigest()


def verify(secret: bytes, method: str, path: str, body: bytes,
           signature: Optional[str]) -> bool:
    if not signature:
        return False
    return hmac.compare_digest(sign(secret, method, path, body), signature)

