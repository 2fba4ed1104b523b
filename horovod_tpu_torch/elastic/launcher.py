"""The elastic launch: the driver wired into the launcher.

The port's copy of ``horovod_tpu/elastic/launcher.py`` (reference
``runner/gloo_run.py:287-336``, ``launch_gloo_elastic``): host the stores
(``runner/launch.py::start_stores``), build discovery from the script (or
fixed hosts), let the driver spawn a worker per slot with the elastic
environment (``HOROVOD_ELASTIC=1``, the epoch it is born at, the job's
key), watch each worker's exit, and finish when the surviving workers
have.

With ``HOROVOD_RENDEZVOUS_EXTERNAL=host:port`` the driver works on a
supervised, journaled server in another process: it first adopts the
epoch and the live workers that the server holds
(``ElasticDriver.recover_from_store``; nothing on a fresh journal), and a
server that is killed and started again over its journal is ridden out by
the driver's store-outage mode.  Give each job its own journal directory:
an old job's state would be adopted too.  With ``HOROVOD_TIMELINE`` (or
``--timeline-filename``) the launcher writes the driver's trace at
``<path>.driver``.

``--host-discovery tpu-metadata`` is refused: on a GPU host the discovery
script takes the TPU-VM metadata's role.
"""

from __future__ import annotations

import signal
import subprocess
import threading
import time
from typing import Dict, List

from ..common import env as env_mod
from ..common.logging_util import get_logger
from ..core import timeline as timeline_mod
from ..runner import config_parser
from ..runner.hosts import SlotInfo, parse_host_files, parse_hosts
from ..runner.launch import (
    _is_local,
    _pumps,
    _slot_env,
    spawn_worker,
    start_stores,
)
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
    discovery = _discovery(args)
    found = discovery.find_available_hosts_and_slots()
    local_only = all(_is_local(h) for h in found)
    extra = config_parser.env_from_args(args)
    extra[env_mod.HOROVOD_ELASTIC] = "1"
    if args.reset_limit:
        extra[env_mod.HOROVOD_ELASTIC_RESET_LIMIT] = str(args.reset_limit)
    server, rdv_addr, rdv_port, tcp = start_stores(local_only, extra)
    min_np = args.min_np or args.num_proc
    driver_kwargs = {}
    if args.start_timeout:
        driver_kwargs["timeout"] = args.start_timeout
    driver = ElasticDriver(
        server, HostManager(discovery), min_np=min_np,
        max_np=args.max_np, reset_limit=args.reset_limit, **driver_kwargs)
    if env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_EXTERNAL):
        driver.recover_from_store()
    driver_timeline = None
    timeline_path = extra.get(env_mod.HOROVOD_TIMELINE) or \
        env_mod.get_str(env_mod.HOROVOD_TIMELINE)
    if timeline_path:
        # The launcher's active timeline: the driver's spans and the store
        # client's RVC_* land in it.  Its clock is taken as the server's,
        # as the JAX launcher does (offset 0).
        driver_timeline = timeline_mod.Timeline(
            f"{timeline_path}.driver", rank=timeline_mod.DRIVER_TRACE_PID,
            clock_offset_ns=0, process_name="elastic driver")

    procs: Dict[str, subprocess.Popen] = {}
    lock = threading.Lock()

    def create_worker(slot: SlotInfo, epoch: int) -> None:
        env = _slot_env(slot, rdv_addr, rdv_port, extra)
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
        server.stop()
        tcp.close()
        if driver_timeline is not None:
            driver_timeline.close()
