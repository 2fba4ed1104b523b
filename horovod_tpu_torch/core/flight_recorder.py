"""The flight recorder: a ring of recent events, dumped when the loop dies.

Counterpart of ``horovod_tpu/core/flight_recorder.py``, less the held
locks of its lockdep (not ported).  Every rank keeps its last
``HOROVOD_FLIGHT_RECORDER_EVENTS`` events (straggler flags, demotion
verdicts, busy cycles, the abort); when the background loop dies it
writes ``{reason, metrics snapshot, events}`` to
``hvd_flight_recorder/hvd_flight_recorder.rank<N>.json`` under
``HOROVOD_FLIGHT_RECORDER_DIR`` (default: the worker's directory), through a temporary file and
``os.replace`` so that a half-written dump never lands.
``HOROVOD_FLIGHT_RECORDER=0`` turns recording and dumping off.

The ring is a ``deque`` with a length cap: appending and copying it are
single steps, so the recorder takes no lock.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import List, Optional

from ..common import env as env_mod
from ..common.logging_util import get_logger

log = get_logger("horovod_tpu_torch.flight_recorder")

DUMP_FORMAT = "hvd-flight-recorder-v1"


def _dump_filename(rank: int) -> str:
    return f"hvd_flight_recorder.rank{rank}.json"


class FlightRecorder:
    def __init__(self):
        self.enabled = env_mod.get_bool(env_mod.HOROVOD_FLIGHT_RECORDER,
                                        True)
        self._events: collections.deque = collections.deque(maxlen=max(
            1, env_mod.get_int(env_mod.HOROVOD_FLIGHT_RECORDER_EVENTS,
                               env_mod.DEFAULT_FLIGHT_RECORDER_EVENTS)))

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        evt = {"t_mono": time.monotonic(), "t_wall": time.time(),
               "thread": threading.current_thread().name, "kind": kind}
        evt.update(fields)
        self._events.append(evt)

    def events(self) -> List[dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the post-mortem; returns its path (None when the recorder
        is off or the write failed).  Never raises: a failing dump must
        not hide the error it records."""
        if not self.enabled:
            return None
        rank = env_mod.get_int(env_mod.HOROVOD_RANK, 0)
        if path is None:
            dump_dir = os.path.join(
                env_mod.get_str(env_mod.HOROVOD_FLIGHT_RECORDER_DIR) or ".",
                "hvd_flight_recorder")
            try:
                os.makedirs(dump_dir, exist_ok=True)
            except OSError as e:
                log.error("flight-recorder dir %s failed: %s", dump_dir, e)
                return None
            path = os.path.join(dump_dir, _dump_filename(rank))
        doc = {
            "format": DUMP_FORMAT,
            "reason": reason,
            "rank": rank,
            "pid": os.getpid(),
            "ts_unix": time.time(),
            "metrics": self._metrics_snapshot(),
            "events": self.events(),
        }
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except OSError as e:
            log.error("flight-recorder dump to %s failed: %s", path, e)
            return None

    @staticmethod
    def _metrics_snapshot() -> dict:
        from . import metrics

        try:
            return metrics.registry.snapshot()
        except Exception as e:  # noqa: BLE001 — the dump must still land
            return {"error": f"metrics snapshot failed: {e}"}


#: The process's recorder.
recorder = FlightRecorder()


def record(kind: str, **fields) -> None:
    if recorder.enabled:
        recorder.record(kind, **fields)
