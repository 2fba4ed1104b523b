"""The launcher (reference ``horovodrun``).

Counterpart of ``horovod_tpu/runner/launch.py``: parse the arguments,
assign slots, host the rendezvous store, start one worker per slot with its
``HOROVOD_*`` environment (``ssh`` for a remote host), stream each worker's
output with its rank in front, and end the job when a worker fails.  The
store is a ``torch.distributed.TCPStore`` (``transport/store.py``), bound to
127.0.0.1 when every slot is on this host; the workers' runtime joins its
process groups through it.

Usage::

    python -m horovod_tpu_torch.runner.launch -np 2 python train.py
    python -m horovod_tpu_torch.runner.launch -np 8 -H h1:4,h2:4 python train.py
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ..common import env as env_mod
from ..transport.store import StoreServer
from .hosts import SlotInfo, get_host_assignments, parse_hosts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.launch",
        description="Launch a horovod_tpu_torch job (reference: horovodrun).")
    p.add_argument("-np", "--num-proc", type=int, required=True,
                   help="number of worker processes")
    p.add_argument("-H", "--hosts", default=None,
                   help='host list like "h1:4,h2:4"; default localhost:np')
    p.add_argument("--start-timeout", type=int, default=None,
                   help="abort unless every worker reaches hvd.init() within "
                        "this many seconds (default: wait forever)")
    p.add_argument("--data-plane", default=None,
                   choices=[env_mod.PLANE_HOST, "tcp", env_mod.PLANE_NCCL],
                   help="where the cross-rank allreduce runs: the host "
                        "(cpu, the default) or the card (nccl)")
    # Runtime knobs, which become every rank's HOROVOD_* environment
    # (horovod_tpu/runner/launch.py:58-63).
    p.add_argument("--cache-capacity", type=int, default=None,
                   help="response cache entries (default 1024; 0 turns "
                        "the cache off)")
    p.add_argument("--no-stall-check", action="store_true", default=False,
                   help="turn the stall warnings off")
    p.add_argument("--stall-check-warning-time-seconds", type=int,
                   default=None,
                   help="warn about a tensor some ranks have waited on "
                        "this long (default 60)")
    p.add_argument("--stall-check-shutdown-time-seconds", type=int,
                   default=None,
                   help="end the job, on every rank, when a tensor has "
                        "waited this long (default 0: never)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the command to run on every slot")
    return p


def runtime_env(args) -> Dict[str, str]:
    """The ``HOROVOD_*`` variables the command line sets on every rank."""
    env: Dict[str, str] = {}
    if args.data_plane is not None:
        env[env_mod.HOROVOD_DATA_PLANE] = args.data_plane
    if args.cache_capacity is not None:
        env[env_mod.HOROVOD_CACHE_CAPACITY] = str(args.cache_capacity)
    if args.no_stall_check:
        env[env_mod.HOROVOD_STALL_CHECK_DISABLE] = "1"
    if args.stall_check_warning_time_seconds is not None:
        env[env_mod.HOROVOD_STALL_CHECK_TIME_SECONDS] = str(
            args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        env[env_mod.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] = str(
            args.stall_check_shutdown_time_seconds)
    return env


def _slot_env(slot: SlotInfo, rdv_addr: str, rdv_port: int,
              extra: Dict[str, str]) -> Dict[str, str]:
    env = os.environ.copy()
    env.update(slot.to_env())
    env.update({
        env_mod.HOROVOD_RENDEZVOUS_ADDR: rdv_addr,
        env_mod.HOROVOD_RENDEZVOUS_PORT: str(rdv_port),
    })
    env.update(extra)
    # The package is importable in the workers whatever their directory.
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = env.get("PYTHONPATH", "").split(os.pathsep)
    if pkg_parent not in parts:
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_parent] + [p for p in parts if p])
    return env


def _is_local(hostname: str) -> bool:
    # All of 127.0.0.0/8 is this machine.
    return hostname.startswith("127.") or hostname in (
        "localhost", socket.gethostname())


def _ssh_command(slot: SlotInfo, command: List[str],
                 env: Dict[str, str]) -> List[str]:
    """A remote slot's command line: the ``HOROVOD_*`` variables, the
    ``PYTHONPATH`` and the ``PATH`` travel explicitly through ``ssh`` and
    the worker starts in this directory (reference ``gloo_run.py:133-183``)."""
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in env.items()
        if k.startswith("HOROVOD_") or k in ("PYTHONPATH", "PATH"))
    remote = f"cd {shlex.quote(os.getcwd())} && env {exports} " + \
        " ".join(shlex.quote(c) for c in command)
    return ["ssh", "-o", "StrictHostKeyChecking=no", slot.hostname, remote]


def spawn_worker(slot: SlotInfo, command: List[str],
                 env: Dict[str, str]) -> subprocess.Popen:
    cmd = command if _is_local(slot.hostname) else \
        _ssh_command(slot, command, env)
    return subprocess.Popen(cmd, env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


class _OutputPump(threading.Thread):
    """Forwards a worker's stream line by line with its rank in front."""

    def __init__(self, stream, sink, prefix: str, name: str):
        super().__init__(daemon=True, name=name)
        self._stream = stream
        self._sink = sink
        self._prefix = prefix
        self.start()

    def run(self):
        for line in self._stream:
            self._sink.write(f"{self._prefix}{line}")
            self._sink.flush()


def _terminate(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)


def launch_job(args, command: List[str]) -> int:
    """Run ``command`` once per slot; the job's exit code is the first
    failing worker's (the others are terminated), or 0."""
    slots = get_host_assignments(
        parse_hosts(args.hosts or f"localhost:{args.num_proc}"),
        args.num_proc)
    local_only = all(_is_local(s.hostname) for s in slots)
    server = StoreServer(local_only)
    rdv_addr = "127.0.0.1" if local_only else \
        socket.gethostbyname(socket.gethostname())
    extra = runtime_env(args)
    procs: List[subprocess.Popen] = []
    pumps: List[_OutputPump] = []
    try:
        for slot in slots:
            proc = spawn_worker(slot, command,
                                _slot_env(slot, rdv_addr, server.port, extra))
            procs.append(proc)
            pumps.append(_OutputPump(proc.stdout, sys.stdout,
                                     f"[{slot.rank}]<stdout>: ",
                                     name=f"hvd-pump-r{slot.rank}-out"))
            pumps.append(_OutputPump(proc.stderr, sys.stderr,
                                     f"[{slot.rank}]<stderr>: ",
                                     name=f"hvd-pump-r{slot.rank}-err"))
        # Poll every worker: a crash in any rank ends the job even while
        # the others block in collectives.  --start-timeout: each worker
        # checks in ``worker_started`` when its runtime connects.
        exit_code: Optional[int] = None
        deadline = (time.monotonic() + args.start_timeout
                    if args.start_timeout and len(slots) > 1 else None)
        unstarted = {s.rank for s in slots} if deadline else set()
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed and exit_code is None:
                exit_code = failed[0]
                _terminate(procs)
            if unstarted and exit_code is None:
                unstarted = {r for r in unstarted if server.store.get(
                    "worker_started", str(r)) is None}
                if unstarted and time.monotonic() > deadline:
                    print(f"launch: ranks {sorted(unstarted)} failed to start "
                          f"within --start-timeout={args.start_timeout}s; "
                          "aborting", file=sys.stderr, flush=True)
                    exit_code = 1
                    _terminate(procs)
            if all(c is not None for c in codes):
                break
            time.sleep(0.1)
        for pump in pumps:
            pump.join(timeout=5)
        return exit_code or 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.close()


def _exit_on_sigterm(signum, frame):
    # Unwind through launch_job's ``finally``, which stops the workers.
    sys.exit(128 + signum)


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("launch: no command given", file=sys.stderr)
        return 2
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    return launch_job(args, command)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
