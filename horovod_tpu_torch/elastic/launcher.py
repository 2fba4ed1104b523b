"""The elastic launch: the driver wired into the launcher.

The port's copy of ``horovod_tpu/elastic/launcher.py`` (reference
``runner/gloo_run.py:287-336``, ``launch_gloo_elastic``): host the store,
build discovery from the script (or fixed hosts), let the driver spawn a
worker per slot with the elastic environment (``HOROVOD_ELASTIC=1``, the
epoch it is born at, the job's key), watch each worker's exit, and finish
when the surviving workers have.

Refused, each naming its item of ROADMAP A6: ``--host-discovery
tpu-metadata`` (TPU-VM metadata; on a GPU host the discovery script takes
its role) and ``HOROVOD_RENDEZVOUS_EXTERNAL`` (the JAX package's journaled
external rendezvous server).
"""

from __future__ import annotations

import signal
import socket
import subprocess
import threading
import time
from typing import Dict, List

from ..common import env as env_mod
from ..common import secret as secret_mod
from ..common.logging_util import get_logger
from ..runner import config_parser
from ..runner.hosts import SlotInfo, parse_host_files, parse_hosts
from ..runner.launch import _is_local, _pumps, _slot_env, spawn_worker
from ..transport.store import StoreServer
from .discovery import FixedHosts, HostDiscoveryScript, HostManager
from .driver import ElasticDriver
from .registration import FAILURE, SUCCESS

log = get_logger("horovod_tpu_torch.elastic.launcher")


def _discovery(args):
    mode = args.host_discovery or (
        "script" if args.host_discovery_script else None)
    if mode == "tpu-metadata":
        raise SystemExit(
            "launch: --host-discovery tpu-metadata reads TPU-VM metadata, "
            "which a GPU host does not have (ROADMAP A6: "
            "elastic/tpu_metadata.py); list the healthy hosts with "
            "--host-discovery-script instead")
    if mode == "script":
        if not args.host_discovery_script:
            raise SystemExit("launch: --host-discovery script needs "
                             "--host-discovery-script")
        return HostDiscoveryScript(args.host_discovery_script)
    hosts = parse_host_files(args.hostfile) if args.hostfile else args.hosts
    return FixedHosts(parse_hosts(hosts or f"localhost:{args.num_proc}"))


def launch_elastic_job(args, command: List[str]) -> int:
    if env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_EXTERNAL):
        raise SystemExit(
            f"launch: {env_mod.HOROVOD_RENDEZVOUS_EXTERNAL} names the JAX "
            "package's journaled external rendezvous server, which this "
            "port does not have (ROADMAP A6: the journaled rendezvous "
            "server); unset it: the launcher hosts the store")
    discovery = _discovery(args)
    secret_mod.ensure_job_secret()
    found = discovery.find_available_hosts_and_slots()
    local_only = all(_is_local(h) for h in found)
    server = StoreServer(local_only)
    rdv_addr = "127.0.0.1" if local_only else \
        socket.gethostbyname(socket.gethostname())
    min_np = args.min_np or args.num_proc
    driver_kwargs = {}
    if args.start_timeout:
        driver_kwargs["timeout"] = args.start_timeout
    driver = ElasticDriver(
        server.store, HostManager(discovery), min_np=min_np,
        max_np=args.max_np, reset_limit=args.reset_limit, **driver_kwargs)
    extra = config_parser.env_from_args(args)
    extra[env_mod.HOROVOD_ELASTIC] = "1"
    if args.reset_limit:
        extra[env_mod.HOROVOD_ELASTIC_RESET_LIMIT] = str(args.reset_limit)

    procs: Dict[str, subprocess.Popen] = {}
    lock = threading.Lock()

    def create_worker(slot: SlotInfo, epoch: int) -> None:
        env = _slot_env(slot, rdv_addr, server.port, extra)
        env[env_mod.HOROVOD_EPOCH] = str(epoch)
        proc = spawn_worker(slot, command, env)
        identity = f"{slot.hostname}:{slot.local_rank}"
        with lock:
            procs[identity] = proc
        _pumps(proc, slot.rank, args)
        threading.Thread(target=monitor, args=(identity, slot, proc),
                         name=f"hvd-elastic-mon-{identity}",
                         daemon=True).start()

    def monitor(identity: str, slot: SlotInfo, proc: subprocess.Popen):
        code = proc.wait()
        with lock:
            if procs.get(identity) is proc:
                procs.pop(identity, None)
        log.info("worker %s exited with %d", identity, code)
        driver.record_worker_exit(slot, code)

    try:
        driver.start(create_worker)
        while True:
            time.sleep(0.5)
            with lock:
                alive = len(procs)
            successes = driver.registry.count(SUCCESS)
            failures = driver.registry.count(FAILURE)
            current = len(driver.current_slots)
            if successes and successes >= current and alive == 0:
                return 0
            if alive == 0 and failures and \
                    driver.hosts.total_slots() < min_np:
                log.error("all capacity lost (%d failures)", failures)
                return 1
            if driver.stopped_error:
                log.error("elastic driver stopped: %s", driver.stopped_error)
                return 1
    finally:
        driver.stop()
        with lock:
            live = list(procs.values())
        for proc in live:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)
        for proc in live:
            if proc.poll() is None:
                proc.kill()
        server.close()
