"""Distributed checkpoints: rank 0 writes and reads, every rank agrees.

Counterpart of ``horovod_tpu/frameworks/jax/checkpoint.py``, with its
protocol and names; the payload is one ``torch.save`` file
(:data:`PAYLOAD_FILE`) inside the snapshot's directory instead of an orbax
tree.  Rank 0 moves every tensor to the CPU before saving, and loads with
``torch.load(..., weights_only=True)``, which admits dicts, lists, tensors
and numbers: a model's and an optimizer's ``state_dict`` and a ``step``.

A snapshot is published atomically and committed by a manifest written
last:

1. the payload is written to ``<path>.tmp-<pid>``;
2. its CRC32 is taken (:func:`_payload_crc`: the relative paths and the
   bytes of every file, in sorted walk order);
3. an old payload at ``path`` is moved aside and then removed, never
   removed in place; the new one is moved to ``path`` with ``os.replace``;
4. the manifest (``format``, ``crc32``, ``bytes``, ``files``, ``step``) is
   written to ``<path>.manifest.json`` through its own temporary file.

A snapshot without its manifest, or whose CRC disagrees with it, is not
valid (:func:`snapshot_valid`): a crash at any point leaves the previous
snapshot or an invalid one, which :func:`restore_latest` logs and skips.
The ``ckpt.save`` fault site sits between steps 3 and 4.

Usage::

    hvd.checkpoint.save(path, {"model": model.state_dict(),
                               "opt": opt.state_dict(), "step": 5})
    state = hvd.checkpoint.restore(path, like=...)

    hvd.checkpoint.save_rotating(base, state, keep=3)
    state = hvd.checkpoint.restore_latest(base)

Rank 0 does the I/O and broadcasts its verdict, so every rank raises the
same typed error together: a missing (or nowhere valid) checkpoint raises
:class:`CheckpointNotFoundError` on every rank, any other failure of rank 0
``HorovodInternalError``.  The restored tree is broadcast from rank 0 with
``broadcast_object``: every rank returns the same state even when only rank
0 sees the directory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import torch

from . import functions as _functions
from .basics import rank
from .common import faults
from .common.exceptions import CheckpointNotFoundError, HorovodInternalError
from .common.logging_util import get_logger

log = get_logger("horovod_tpu_torch.checkpoint")

MANIFEST_SUFFIX = ".manifest.json"
#: The payload's one file inside a snapshot's directory.
PAYLOAD_FILE = "state.pt"
_SEQ_RE = re.compile(r"\.(\d{8})$")


# ---------------------------------------------------------------------------
# rank 0's snapshot primitives (no collectives)
# ---------------------------------------------------------------------------

def _manifest_path(path: str) -> str:
    return path + MANIFEST_SUFFIX


def _payload_crc(path: str) -> Tuple[int, int, int]:
    """CRC32 over every payload file, walked in sorted relative-path order
    (the relative paths feed the CRC too, so a renamed or missing file
    changes it).  Returns ``(crc, total_bytes, file_count)``."""
    crc = 0
    total = 0
    count = 0
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames.sort()
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, path)
            crc = zlib.crc32(rel.encode("utf-8"), crc)
            with open(full, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
                    total += len(chunk)
            count += 1
    return crc & 0xFFFFFFFF, total, count


def _step_of(state: Any) -> Optional[int]:
    """The manifest's ``step``: ``state["step"]`` where there is one."""
    try:
        return int(state["step"])
    except Exception:  # noqa: BLE001 — metadata only, never fails a save
        return None


def _to_cpu(tree: Any) -> Any:
    """The tree with every tensor detached and on the CPU; dicts (their
    type kept), lists and tuples rebuilt, other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        out = type(tree)()
        for k, v in tree.items():
            out[k] = _to_cpu(v)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _publish_snapshot(path: str, state: Any,
                      step: Optional[int] = None) -> dict:
    """Publish ``state`` at ``path`` atomically (rank 0 only); the steps of
    the module's docstring, in order.  Returns the manifest."""
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)  # left by an earlier crashed attempt
    os.makedirs(tmp)
    torch.save(_to_cpu(state), os.path.join(tmp, PAYLOAD_FILE))
    crc, nbytes, nfiles = _payload_crc(tmp)
    manifest = {
        "format": 1,
        "crc32": crc,
        "bytes": nbytes,
        "files": nfiles,
        "step": step if step is not None else _step_of(state),
    }
    if os.path.exists(path):
        # Move the old payload aside, then delete it: a crash while
        # deleting in place would leave a half-deleted tree at ``path``
        # with no manifest, which restore() would load unverified.  This
        # way ``path`` is always absent, the whole old tree or the whole
        # new one.
        old = f"{path}.old-{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.replace(path, old)
        _remove_quiet(_manifest_path(path))
        shutil.rmtree(old, ignore_errors=True)
    os.replace(tmp, path)
    if faults.ACTIVE:
        faults.inject("ckpt.save")
    mtmp = f"{_manifest_path(path)}.tmp-{os.getpid()}"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, _manifest_path(path))
    return manifest


def _remove_quiet(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def snapshot_valid(path: str) -> Tuple[bool, str]:
    """``(ok, reason)``: is the snapshot at ``path`` restorable?  The reason
    names what failed, for :func:`restore_latest`'s log."""
    if not os.path.isdir(path):
        return False, "payload directory missing"
    mpath = _manifest_path(path)
    if not os.path.exists(mpath):
        return False, "no manifest (half-written: crashed before commit)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable: {e}"
    crc, nbytes, nfiles = _payload_crc(path)
    if crc != manifest.get("crc32") or nfiles != manifest.get("files"):
        return False, (
            f"payload CRC mismatch: manifest says crc32=0x"
            f"{manifest.get('crc32', 0):08X}/{manifest.get('files')} files,"
            f" disk has 0x{crc:08X}/{nfiles} files")
    return True, "ok"


def _list_snapshots(base: str) -> List[Tuple[int, str]]:
    """The rotating snapshots ``<base>.<8 digits>``, newest first."""
    parent = os.path.dirname(base) or "."
    prefix = os.path.basename(base)
    found = []
    try:
        entries = os.listdir(parent)
    except OSError:
        return []
    for name in entries:
        if not name.startswith(prefix + "."):
            continue
        m = _SEQ_RE.search(name)
        if m and name == f"{prefix}.{m.group(1)}":
            found.append((int(m.group(1)), os.path.join(parent, name)))
    return sorted(found, reverse=True)


def _load_payload(abspath: str) -> Any:
    return torch.load(os.path.join(abspath, PAYLOAD_FILE), map_location="cpu",
                      weights_only=True)


def _conform(stored: Any, like: Any, where: str = "state") -> Any:
    """``stored`` shaped by ``like``: every tensor takes the device and
    dtype of ``like``'s tensor at the same place; dict keys, sequence
    lengths and tensor shapes must match, or this raises ``ValueError``.
    A leaf of ``like`` that is not a tensor keeps the stored value."""
    if isinstance(like, torch.Tensor):
        if not isinstance(stored, torch.Tensor) or stored.shape != like.shape:
            got = tuple(stored.shape) if isinstance(stored, torch.Tensor) \
                else type(stored).__name__
            raise ValueError(f"checkpoint {where}: stored {got}, expected a "
                             f"tensor of shape {tuple(like.shape)}")
        return stored.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict):
        if not isinstance(stored, dict) or set(stored) != set(like):
            got = sorted(map(str, stored)) if isinstance(stored, dict) \
                else type(stored).__name__
            raise ValueError(f"checkpoint {where}: stored keys {got}, "
                             f"expected {sorted(map(str, like))}")
        out = type(like)()
        for k, v in like.items():
            out[k] = _conform(stored[k], v, f"{where}[{k!r}]")
        return out
    if isinstance(like, (list, tuple)):
        if not isinstance(stored, (list, tuple)) or len(stored) != len(like):
            raise ValueError(f"checkpoint {where}: stored {stored!r:.80}, "
                             f"expected a sequence of {len(like)}")
        return type(like)(_conform(s, v, f"{where}[{i}]")
                          for i, (s, v) in enumerate(zip(stored, like)))
    return stored


# ---------------------------------------------------------------------------
# the distributed API (rank 0 does the I/O; verdicts and state broadcast)
# ---------------------------------------------------------------------------

def save(path: str, state: Any) -> None:
    """Rank 0 publishes ``state`` at ``path``; its success or its failure
    reaches every rank, and a failure raises on every rank."""
    err = None
    if rank() == 0:
        try:
            _publish_snapshot(os.path.abspath(path), state)
        except BaseException as e:  # noqa: BLE001 — marshalled to peers
            err = ("internal", f"{type(e).__name__}: {e}")
    _raise_if_root_failed(err, "ckpt.save")


def restore(path: str, like: Optional[Any] = None) -> Any:
    """Rank 0 reads the snapshot at ``path`` and every rank returns it.

    A missing checkpoint raises :class:`CheckpointNotFoundError` on every
    rank; one that fails its manifest's check raises
    ``HorovodInternalError`` naming what failed.  A snapshot without a
    manifest (written before manifests existed) loads unverified.  With
    ``like``, the tree is shaped by it (:func:`_conform`) on each rank;
    without it, the stored CPU tree comes back as it is."""
    state, err = None, None
    if rank() == 0:
        abspath = os.path.abspath(path)
        if not os.path.exists(abspath):
            err = ("not_found", f"no checkpoint at {abspath}")
        else:
            try:
                if os.path.exists(_manifest_path(abspath)):
                    ok, reason = snapshot_valid(abspath)
                    if not ok:
                        raise IOError(
                            f"checkpoint {abspath} failed integrity "
                            f"verification: {reason}")
                state = _load_payload(abspath)
            except BaseException as e:  # noqa: BLE001 — marshalled to peers
                err = ("internal", f"{type(e).__name__}: {e}")
    _raise_if_root_failed(err, "ckpt.restore")
    state = _functions.broadcast_object(state, root_rank=0,
                                        name="ckpt.restore.state")
    return state if like is None else _conform(state, like)


def save_rotating(base: str, state: Any, keep: int = 3,
                  step: Optional[int] = None) -> str:
    """Publish a new snapshot ``<base>.<seq>`` (an 8-digit sequence, one
    above the newest) and prune to the newest ``keep``.  Returns the
    published path on every rank."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1 (got {keep})")
    err, published = None, None
    if rank() == 0:
        try:
            abs_base = os.path.abspath(base)
            snaps = _list_snapshots(abs_base)
            seq = (snaps[0][0] + 1) if snaps else 1
            published = f"{abs_base}.{seq:08d}"
            _publish_snapshot(published, state, step=step)
            for _, old in _list_snapshots(abs_base)[keep:]:
                shutil.rmtree(old, ignore_errors=True)
                _remove_quiet(_manifest_path(old))
        except BaseException as e:  # noqa: BLE001 — marshalled to peers
            err = ("internal", f"{type(e).__name__}: {e}")
    _raise_if_root_failed(err, "ckpt.save_rotating")
    return _functions.broadcast_object(published, root_rank=0,
                                       name="ckpt.save_rotating.path")


def restore_latest(base: str, like: Optional[Any] = None) -> Any:
    """Restore the newest valid snapshot under ``base``.  Rank 0 checks
    them newest first; one that fails its check, or fails to load, is
    logged with its reason and skipped.  With none valid,
    :class:`CheckpointNotFoundError` on every rank.  ``like`` as in
    :func:`restore`."""
    state, err = None, None
    if rank() == 0:
        abs_base = os.path.abspath(base)
        snaps = _list_snapshots(abs_base)
        restored = False
        for _, snap in snaps:
            ok, reason = snapshot_valid(snap)
            if not ok:
                log.warning("restore_latest: skipping snapshot %s: %s",
                            snap, reason)
                continue
            try:
                state = _load_payload(snap)
            except BaseException as e:  # noqa: BLE001 — fall back further
                log.warning("restore_latest: snapshot %s verified but "
                            "failed to load (%s: %s); falling back",
                            snap, type(e).__name__, e)
                continue
            log.info("restore_latest: restored %s", snap)
            restored = True
            break
        if not restored:
            err = ("not_found",
                   f"no valid snapshot under {abs_base} "
                   f"({len(snaps)} candidates examined)")
    _raise_if_root_failed(err, "ckpt.restore_latest")
    state = _functions.broadcast_object(state, root_rank=0,
                                        name="ckpt.restore_latest.state")
    return state if like is None else _conform(state, like)


def exists(path: str) -> bool:
    """Rank 0's answer, on every rank.  ``exists()`` then ``restore()``
    races (the snapshot can vanish or turn out corrupt between the calls):
    prefer catching :class:`CheckpointNotFoundError`."""
    present = False
    if rank() == 0:
        present = os.path.exists(path)
    return bool(_functions.broadcast_object(present, root_rank=0,
                                            name="ckpt.exists"))


def _raise_if_root_failed(err: Optional[Tuple[str, str]],
                          name: str) -> None:
    """Broadcast rank 0's ``(kind, message)`` verdict; every rank raises
    the same typed error together (a barrier would leave the others
    waiting forever if rank 0 never reached it)."""
    status = _functions.broadcast_object(err, root_rank=0,
                                         name=f"{name}.status")
    if status is None:
        return
    kind, message = status
    if kind == "not_found":
        raise CheckpointNotFoundError(message)
    raise HorovodInternalError(f"rank 0 checkpoint I/O failed: {message}")
