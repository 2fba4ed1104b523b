"""The launcher (reference ``horovodrun``).

Counterpart of ``horovod_tpu/runner/launch.py``: parse the arguments and
the ``--config-file``, assign slots, host the rendezvous store, start one
worker per slot with its ``HOROVOD_*`` environment (``ssh`` for a remote
host), stream each worker's output (with its rank in front under
``--verbose``; into ``DIR/rank.<r>/stdout`` and ``stderr`` as well under
``--output-filename DIR``), and end the job when a worker fails.  The
launcher hosts two stores, bound to 127.0.0.1 when every slot is on this
host: the HTTP rendezvous server (``runner/rendezvous.py``;
``HOROVOD_GLOO_RENDEZVOUS_ADDR``/``_PORT``), or with
``HOROVOD_RENDEZVOUS_EXTERNAL=host:port`` the supervised one it names; and
a ``torch.distributed.TCPStore`` (``transport/store.py``;
``HOROVOD_TORCH_STORE_ADDR``/``_PORT``), through which the workers' runtime
builds its process groups.

Usage::

    python -m horovod_tpu_torch.runner.launch -np 2 python train.py
    python -m horovod_tpu_torch.runner.launch -np 8 -H h1:4,h2:4 \\
        python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 -v \\
        --timeline-filename tl.json --output-filename logs python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 --min-np 1 \\
        --host-discovery-script ./hosts.sh python train.py

Any of ``--min-np``, ``--host-discovery-script`` and ``--host-discovery``
makes the job elastic (``elastic/launcher.py``).
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
from ..common import faults
from ..common import secret as secret_mod
from ..transport.store import StoreServer
from . import config_parser
from .rendezvous import ExternalRendezvous, RendezvousServer
from .hosts import (
    SlotInfo,
    get_host_assignments,
    parse_host_files,
    parse_hosts,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner.launch",
        description="Launch a horovod_tpu_torch job (reference: horovodrun).")
    p.add_argument("-np", "--num-proc", type=int, required=True,
                   help="number of worker processes")
    p.add_argument("-H", "--hosts", default=None,
                   help='host list like "h1:4,h2:4"; default localhost:np')
    p.add_argument("--hostfile", default=None,
                   help="file with one 'host slots=N' per line, in place "
                        "of -H")
    p.add_argument("--output-filename", default=None,
                   help="also write each rank's output into "
                        "<dir>/rank.N/stdout|stderr")
    p.add_argument("--verbose", "-v", action="count", default=0,
                   help="put [rank]<stdout>: / [rank]<stderr>: in front of "
                        "each worker line")
    p.add_argument("--start-timeout", type=int, default=None,
                   help="abort unless every worker reaches hvd.init() within "
                        "this many seconds (default: wait forever)")
    p.add_argument("--config-file", default=None,
                   help="YAML file whose keys mirror the flags (flags win)")
    p.add_argument("--data-plane", default=None,
                   choices=[env_mod.PLANE_HOST, "tcp", env_mod.PLANE_NCCL],
                   help="where the cross-rank allreduce runs: the host "
                        "(cpu, the default) or the card (nccl)")
    # Runtime knobs, which become every rank's HOROVOD_* environment
    # (runner/config_parser.py; horovod_tpu/runner/launch.py:58-79).
    p.add_argument("--fusion-threshold-mb", type=float, default=None,
                   help="fusion buffer size in MB (default 64)")
    p.add_argument("--cycle-time-ms", type=float, default=None,
                   help="background cycle time in ms (default 1)")
    p.add_argument("--timeline-filename", default=None,
                   help="write a Chrome trace: rank 0 at this path, rank r "
                        "at <path>.rank<r>")
    p.add_argument("--timeline-mark-cycles", action="store_true",
                   default=False,
                   help="mark each negotiation cycle in the trace")
    p.add_argument("--log-level", default=None,
                   choices=["trace", "debug", "info", "warning", "error"])
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
    # Elastic (horovod_tpu_torch/elastic/launcher.py).
    p.add_argument("--min-np", type=int, default=None,
                   help="elastic: the fewest workers the job runs with")
    p.add_argument("--max-np", type=int, default=None,
                   help="elastic: the most workers the job grows to")
    p.add_argument("--host-discovery-script", default=None,
                   help="elastic: a script printing one host[:slots] per "
                        "line, the hosts that may run workers now")
    p.add_argument("--host-discovery", default=None,
                   choices=["script", "tpu-metadata"],
                   help="elastic: where the hosts come from ('script', "
                        "--host-discovery-script; 'tpu-metadata' is the "
                        "JAX package's TPU-VM source and is refused here)")
    p.add_argument("--reset-limit", type=int, default=None,
                   help="elastic: end the job after this many resets")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the command to run on every slot")
    return p


#: The ``HOROVOD_*`` variables the command line sets on every rank.
runtime_env = config_parser.env_from_args


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


def start_stores(local_only: bool, extra: Dict[str, str]):
    """The job's two stores (see the module docstring).  Returns the
    rendezvous server (a :class:`RendezvousServer` started here, or the
    :class:`ExternalRendezvous` of ``HOROVOD_RENDEZVOUS_EXTERNAL``), the
    address and port the workers dial for it, and the ``StoreServer``;
    the process-group store's address goes into ``extra``.  Without an
    external server the job's key is made here (``HOROVOD_SECRET_KEY``
    when set); an external server's key is the operator's to share."""
    here = "127.0.0.1" if local_only else \
        socket.gethostbyname(socket.gethostname())
    external = env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_EXTERNAL)
    if external:
        server = ExternalRendezvous.from_env(external)
        rdv_addr, rdv_port = server.addr, server.port
    else:
        server = RendezvousServer(
            bind_addr="127.0.0.1" if local_only else "0.0.0.0",
            job_secret=secret_mod.ensure_job_secret().encode())
        rdv_addr, rdv_port = here, server.start()
    tcp = StoreServer(local_only)
    extra[env_mod.HOROVOD_TORCH_STORE_ADDR] = here
    extra[env_mod.HOROVOD_TORCH_STORE_PORT] = str(tcp.port)
    return server, rdv_addr, rdv_port, tcp


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
    """Start one slot's worker, here or over ``ssh``.  The ``worker.spawn``
    fault site fires per spawn, matched on the slot's rank."""
    if faults.ACTIVE:
        faults.inject("worker.spawn", rank=slot.rank)
    cmd = command if _is_local(slot.hostname) else \
        _ssh_command(slot, command, env)
    return subprocess.Popen(cmd, env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


class _OutputPump(threading.Thread):
    """Forwards a worker's stream line by line with ``prefix`` in front,
    and writes each line to ``tee_path`` as well when one is given
    (reference ``gloo_run.py:150-163``)."""

    def __init__(self, stream, sink, prefix: str, tee_path: Optional[str],
                 name: str):
        super().__init__(daemon=True, name=name)
        self._stream = stream
        self._sink = sink
        self._prefix = prefix
        self._tee = open(tee_path, "w") if tee_path else None
        self.start()

    def run(self):
        try:
            for line in self._stream:
                self._sink.write(f"{self._prefix}{line}")
                self._sink.flush()
                if self._tee:
                    self._tee.write(line)
                    self._tee.flush()
        finally:
            if self._tee:
                self._tee.close()


def _pumps(proc: subprocess.Popen, rank: int, args) -> List[_OutputPump]:
    """The two pumps of one worker: the rank prefix only under
    ``--verbose`` (``horovod_tpu/runner/launch.py:340-341``), the
    ``--output-filename`` files when asked for."""
    tees = {"stdout": None, "stderr": None}
    if args.output_filename:
        rank_dir = os.path.join(args.output_filename, f"rank.{rank}")
        os.makedirs(rank_dir, exist_ok=True)
        tees = {k: os.path.join(rank_dir, k) for k in tees}
    return [_OutputPump(stream, sink,
                        f"[{rank}]<{k}>: " if args.verbose else "", tees[k],
                        name=f"hvd-pump-r{rank}-{k[3:]}")
            for k, stream, sink in (("stdout", proc.stdout, sys.stdout),
                                    ("stderr", proc.stderr, sys.stderr))]


def _terminate(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)


def launch_job(args, command: List[str]) -> int:
    """Run ``command`` once per slot; the job's exit code is the first
    failing worker's (the others are terminated), or 0."""
    hosts = parse_host_files(args.hostfile) if args.hostfile else args.hosts
    slots = get_host_assignments(
        parse_hosts(hosts or f"localhost:{args.num_proc}"), args.num_proc)
    local_only = all(_is_local(s.hostname) for s in slots)
    extra = runtime_env(args)
    server, rdv_addr, rdv_port, tcp = start_stores(local_only, extra)
    procs: List[subprocess.Popen] = []
    pumps: List[_OutputPump] = []
    try:
        for slot in slots:
            proc = spawn_worker(slot, command,
                                _slot_env(slot, rdv_addr, rdv_port, extra))
            procs.append(proc)
            pumps.extend(_pumps(proc, slot.rank, args))
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
                unstarted = {r for r in unstarted if tcp.store.get(
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
        server.stop()
        tcp.close()


def _exit_on_sigterm(signum, frame):
    # Unwind through launch_job's ``finally``, which stops the workers.
    sys.exit(128 + signum)


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        config_parser.apply_config_file(args, args.config_file)
    except ValueError as e:
        print(f"launch: {e}", file=sys.stderr)
        return 2
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("launch: no command given", file=sys.stderr)
        return 2
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    # The JAX launcher's rule (horovod_tpu/runner/launch.py:405-418): any
    # elastic flag makes the job elastic.
    if args.host_discovery_script or args.host_discovery \
            or args.min_np is not None:
        from ..elastic.launcher import launch_elastic_job

        return launch_elastic_job(args, command)
    return launch_job(args, command)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
