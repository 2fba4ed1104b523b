"""Global runtime state and the background coordination loop.

Counterpart of ``horovod_tpu/core/state.py`` (the reference's
``HorovodGlobalState`` + ``BackgroundThreadLoop`` / ``RunLoopOnce``,
``operations.cc:117, 361-689``, and the ``Enqueue*`` entry points,
``operations.cc:942-1170``): a singleton owning the topology, the
controller, the tensor queue and the op chain; a background thread that
wakes every cycle, runs one negotiation round and executes the agreed
responses; framework threads enqueue named tensors with callbacks.

Join (``operations.cc:1146-1170``): a rank that has joined executes every
allreduce and Adasum its peers negotiate without it, contributing zeros of
the response's dtype and size (``adasum(0, g) == g``), on the card when its
peers' tensors are there, so that it takes the same plane as they do;
``enqueue_join`` returns an event set when every rank has joined.

A loop that dies leaves its error sticky (``async_error``): the pending
handles fail with its text and so does every later enqueue.  At size > 1
the coordinator's failure reaches every rank as the cycle's verdict (an
``AbortFrame``, ``core/controller.py``), so all ranks stop with the same
text; the flight recorder (``core/flight_recorder.py``) is dumped after
the abort has gone out.

Device work completes on a finalizer thread: an op that queued CUDA work
returns ``Status.in_progress()`` and the finalizer waits on the op's CUDA
event before firing the entries' callbacks (reference
``gpu_operations.h:98-127``), so the loop moves straight on to the next
cycle.

At size > 1 the runtime owns its groups: a gloo control group (negotiation
and the host plane) and, for ``HOROVOD_DATA_PLANE=nccl``, an NCCL group,
both built on the launcher's store and called through their own methods.
torch.distributed's default process group is never touched, so user code
may initialize it before ``hvd.init()`` and keep it after
``hvd.shutdown()``.
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..backend.adasum import Adasum
from ..backend.cuda import (
    LOCAL,
    Allgather,
    Allreduce,
    Alltoall,
    Broadcast,
    nccl_group,
)
from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError
from ..common.logging_util import get_logger
from ..common.topology import ProcessTopology, from_env
from ..transport.control import ControlPlane, gloo_group
from ..transport.store import Store
from . import flight_recorder
from .controller import BARRIER_TENSOR_NAME, JOIN_TENSOR_NAME, Controller
from .messages import DataType, Request, RequestType, Response, ResponseType
from .operation_manager import OperationManager
from .tensor_queue import Status, TensorQueue, TensorTableEntry

log = get_logger("horovod_tpu_torch.state")

#: Per response type, its op (``_register_default_ops``,
#: ``horovod_tpu/core/state.py:509-545``).
_OPS = {
    ResponseType.ALLREDUCE: Allreduce,
    ResponseType.ADASUM: Adasum,
    ResponseType.BROADCAST: Broadcast,
    ResponseType.ALLGATHER: Allgather,
    ResponseType.ALLTOALL: Alltoall,
}


def register_ops(manager: OperationManager, topo: ProcessTopology,
                 device: torch.device, plane: str, control_group=None,
                 device_group=None) -> None:
    """Each collective's op: at size 1 the local one; at size > 1 the
    device plane's on ``device_group`` when ``plane`` is it, then the host
    plane's on ``control_group``, which takes what the device plane's
    leaves (``backend.cuda.plane_takes``)."""
    if topo.size == 1:
        planes = [(LOCAL, None)]
    else:
        planes = [(env_mod.PLANE_HOST, control_group)]
        if plane == env_mod.PLANE_NCCL:
            planes.insert(0, (env_mod.PLANE_NCCL, device_group))
    for rtype, op in _OPS.items():
        for name, group in planes:
            manager.register(rtype, op(topo, device, name, group))


class HorovodGlobalState:
    def __init__(self):
        self.topo: Optional[ProcessTopology] = None
        self.device: Optional[torch.device] = None
        self.controller: Optional[Controller] = None
        self.tensor_queue = TensorQueue()
        self.op_manager = OperationManager()
        self.initialized = threading.Event()
        self.shutdown_requested = threading.Event()
        self.shutdown_complete = threading.Event()
        self.cycle_time_ms = env_mod.DEFAULT_CYCLE_TIME_MS
        self.background: Optional[threading.Thread] = None
        self.init_error: Optional[BaseException] = None
        # The error the background loop died of: every later enqueue
        # raises it.
        self.async_error: Optional[str] = None
        self.cycle_count = 0
        # Enqueues set this event so an idle loop wakes at once instead of
        # sleeping out the cycle; busy cycles skip the sleep entirely.
        self._wake = threading.Event()
        self._last_cycle_had_work = False
        self._finalizer_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._finalizer: Optional[threading.Thread] = None
        # Size > 1: the data plane, the gloo control group and the NCCL
        # group of the device plane.
        self.plane = env_mod.PLANE_HOST
        self.control_group = None
        self.nccl_group = None
        # The launcher's store, and the groups built on it for callers
        # outside the background loop (:meth:`own_group`).
        self.store: Optional[Store] = None
        self._own_groups: list = []
        # Set by enqueue_join; the JOIN response (or the loop's end) sets
        # and clears it.
        self.join_event: Optional[threading.Event] = None

    # ------------------------------------------------------------------

    def initialize(self, device: torch.device,
                   topology: Optional[ProcessTopology] = None) -> None:
        """``InitializeHorovodOnce`` analog (``operations.cc:693-739``):
        spawn the background thread, block until the controller is up."""
        if self.initialized.is_set():
            return
        topo = topology or from_env()
        if topo.size > 1:
            self.plane = self._check_cross_rank(device)
        self.topo = topo
        self.device = device
        self.cycle_time_ms = env_mod.get_float(
            env_mod.HOROVOD_CYCLE_TIME, env_mod.DEFAULT_CYCLE_TIME_MS)
        self.tensor_queue.set_wake_event(self._wake)
        self.background = threading.Thread(
            target=self._background_loop, name="horovod-background", daemon=True)
        self.background.start()
        self.initialized.wait()
        if self.init_error is not None:
            # Leave the object retryable: nothing must look initialized.
            err, self.init_error = self.init_error, None
            self.initialized.clear()
            self.background = None
            raise HorovodInternalError(f"initialization failed: {err}") from err
        atexit.register(self.shutdown)

    @staticmethod
    def _check_cross_rank(device: torch.device) -> str:
        """What size > 1 needs before anything connects: the launcher's
        rendezvous address and a data plane this rank can run.  Returns the
        plane.  Nothing falls back: an unmet request raises."""
        addr = env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR)
        port = env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0)
        if not addr or not port:
            raise HorovodInternalError(
                "size > 1 requires the launcher's rendezvous store "
                f"({env_mod.HOROVOD_RENDEZVOUS_ADDR} and "
                f"{env_mod.HOROVOD_RENDEZVOUS_PORT}; run the job with "
                "python -m horovod_tpu_torch.runner.launch -np N ...)")
        try:
            plane = env_mod.data_plane()
        except ValueError as e:
            raise HorovodInternalError(str(e)) from None
        if plane == env_mod.PLANE_NCCL:
            if device.type != "cuda":
                raise HorovodInternalError(
                    f"{env_mod.HOROVOD_DATA_PLANE}=nccl needs the runtime on "
                    f"a card, but it runs on {device}")
            if not dist.is_nccl_available():
                raise HorovodInternalError(
                    f"{env_mod.HOROVOD_DATA_PLANE}=nccl, but this torch has "
                    "no NCCL")
        return plane

    def _connect(self) -> None:
        """Size > 1: store, check-in, the gloo control group and, for the
        device plane, the NCCL group (``_build_transport``)."""
        topo = self.topo
        timeout = env_mod.get_float(env_mod.HOROVOD_MESH_STARTUP_TIMEOUT,
                                    env_mod.DEFAULT_MESH_STARTUP_TIMEOUT)
        # The membership epoch scopes the groups' store keys; it stays 0
        # until elastic re-init (ROADMAP A6) bumps it.
        epoch = 0
        store = Store.connect(env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR),
                              env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0),
                              timeout)
        store.set("worker_started", str(topo.rank), b"1")
        self.store = store
        self.control_group = gloo_group(store.group_store("control", epoch),
                                        topo.rank, topo.size, timeout)
        if self.plane != env_mod.PLANE_NCCL:
            return
        scope = f"cards.{epoch}"
        store.set(scope, str(topo.rank),
                  str(torch.cuda.get_device_properties(self.device).uuid)
                  .encode())
        cards = [v.decode() for v in store.wait(
            scope, [str(r) for r in range(topo.size)], timeout).values()]
        for r, card in enumerate(cards):
            if cards.index(card) != r:
                raise HorovodInternalError(
                    f"{env_mod.HOROVOD_DATA_PLANE}=nccl needs one card per "
                    f"rank, but ranks {cards.index(card)} and {r} share "
                    f"card {card}: NCCL cannot hold two ranks of one "
                    f"communicator on one device.  Use "
                    f"{env_mod.HOROVOD_DATA_PLANE}=cpu, the host plane")
        self.nccl_group = nccl_group(store.group_store("nccl", epoch),
                                     topo.rank, topo.size, timeout)
        # Bring the communicator up now: a fault shows at init, not in the
        # first step.
        probe = torch.zeros(1, device=self.device)
        self.nccl_group.allreduce([probe]).wait()
        torch.cuda.synchronize(self.device)

    def _destroy_groups(self) -> None:
        for group in (*self._own_groups, self.nccl_group, self.control_group):
            if group is not None:
                group.shutdown()
        self.nccl_group = self.control_group = None
        self._own_groups = []

    def own_group(self, name: str):
        """At size > 1, a group for collectives that a caller issues itself,
        outside the background loop (the whole-step graph's average): NCCL
        for a runtime on the card, gloo on the CPU, rendezvoused through
        the launcher's store under ``name``, which every rank passes in the
        same order.  The runtime's own groups cannot serve: the background
        loop runs its negotiation and ops on them at the same time.  Torn
        down with the runtime."""
        timeout = env_mod.get_float(env_mod.HOROVOD_MESH_STARTUP_TIMEOUT,
                                    env_mod.DEFAULT_MESH_STARTUP_TIMEOUT)
        # The membership epoch (0 until elastic re-init) scopes the keys.
        store = self.store.group_store(name, 0)
        make = nccl_group if self.device.type == "cuda" else gloo_group
        group = make(store, self.topo.rank, self.topo.size, timeout)
        self._own_groups.append(group)
        return group

    def _build(self) -> None:
        """``_build_transport`` and ``_register_default_ops``: the groups
        (size > 1), the controller, the op chain, the finalizer."""
        topo = self.topo
        if topo.size > 1:
            self._connect()
        fusion = env_mod.get_int(
            env_mod.HOROVOD_FUSION_THRESHOLD, env_mod.DEFAULT_FUSION_THRESHOLD)
        stall_secs = 0 if env_mod.get_bool(env_mod.HOROVOD_STALL_CHECK_DISABLE) \
            else env_mod.get_float(env_mod.HOROVOD_STALL_CHECK_TIME_SECONDS,
                                   env_mod.DEFAULT_STALL_CHECK_TIME_SECONDS)
        self.controller = Controller(
            topo, ControlPlane(topo.rank, topo.size, self.control_group)
            if topo.size > 1 else None,
            fusion_threshold_bytes=fusion,
            stall_warning_secs=stall_secs,
            stall_shutdown_secs=env_mod.get_float(
                env_mod.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS,
                env_mod.DEFAULT_STALL_SHUTDOWN_TIME_SECONDS),
            cache_capacity=env_mod.get_int(env_mod.HOROVOD_CACHE_CAPACITY,
                                           env_mod.DEFAULT_CACHE_CAPACITY))
        register_ops(self.op_manager, topo, self.device, self.plane,
                     self.control_group, self.nccl_group)
        self._finalizer = threading.Thread(
            target=self._finalizer_loop, name="horovod-finalizer", daemon=True)
        self._finalizer.start()

    # ------------------------------------------------------------------
    # background loop
    # ------------------------------------------------------------------

    def _background_loop(self) -> None:
        try:
            self._build()
        except BaseException as e:  # noqa: BLE001 — reported by initialize()
            self.init_error = e
            self._destroy_groups()
            self.initialized.set()
            return
        self.initialized.set()
        try:
            while True:
                start = time.monotonic()
                # Clear BEFORE popping: an add landing between pop and a
                # clear-afterwards would lose its wakeup.
                self._wake.clear()
                if not self._run_loop_once():
                    break
                if self._last_cycle_had_work:
                    continue
                cycle = self.cycle_time_ms / 1000.0
                elapsed = time.monotonic() - start
                if elapsed < cycle:
                    self._wake.wait(cycle - elapsed)
        except BaseException as e:  # noqa: BLE001 — fail every waiter
            log.error("background loop died: %s", e, exc_info=True)
            self.async_error = str(e)
            # Rank 0's abort, if it was rank 0's failure, has gone out with
            # the cycle's verdict by now.
            self._dump_flight_recorder(e)
            self._fail_all_pending(self.async_error)
        else:
            self._fail_all_pending("Horovod has been shut down")
        finally:
            # In-flight device work completes (and fires its callbacks)
            # before shutdown is declared done.
            self._finalizer_queue.put(None)
            self._finalizer.join(timeout=60)
            try:
                self._destroy_groups()
            finally:
                self.shutdown_complete.set()

    @staticmethod
    def _dump_flight_recorder(error: BaseException) -> None:
        path = flight_recorder.recorder.dump(
            f"background loop death: {type(error).__name__}: {error}")
        if path:
            log.error("flight-recorder post-mortem written to %s", path)

    def _run_loop_once(self) -> bool:
        """One cycle (``RunLoopOnce``, ``operations.cc:595-689``): negotiate,
        then execute every agreed response.  Returns False to stop."""
        requests = self.tensor_queue.pop_messages()
        response_list = self.controller.compute_response_list(
            requests, self.shutdown_requested.is_set())
        self.cycle_count += 1
        self._last_cycle_had_work = bool(requests) \
            or bool(response_list.responses)
        if self._last_cycle_had_work:
            flight_recorder.record("cycle", n=self.cycle_count,
                                   requests=len(requests),
                                   responses=len(response_list.responses))
        for response in response_list.responses:
            self._perform_operation(response)
        return not response_list.shutdown

    def _perform_operation(self, response: Response) -> None:
        """``PerformOperation`` analog (``operations.cc:256-336``)."""
        if response.response_type == ResponseType.JOIN:
            self._release_join()
            return
        entries = self.tensor_queue.get_entries_for_response(response)
        if response.response_type == ResponseType.ERROR:
            for e in entries:
                self._fire_callback(e, Status.error(response.error_message))
            return
        if response.response_type == ResponseType.BARRIER:
            for e in entries:
                self._fire_callback(e, Status.OK())
            return
        if len(entries) != len(response.tensor_names):
            entries = self._zero_substituted(response, entries)
        try:
            status = self.op_manager.execute(response, entries)
        except HorovodInternalError as e:
            status = Status.error(str(e))
        except Exception as e:  # noqa: BLE001 — the loop must keep serving
            log.error("op execution failed: %s", e, exc_info=True)
            status = Status.error(f"{type(e).__name__}: {e}")
        if status.pending:
            self._finalizer_queue.put(entries)
            return
        for e in entries:
            self._fire_callback(e, status)

    def _zero_substituted(self, response: Response,
                          entries: List[TensorTableEntry]
                          ) -> List[TensorTableEntry]:
        """The response's entries in its order, with zeros for each tensor
        this rank never submitted (reference ``tensor_queue.h:39-41``)."""
        by_name = {e.tensor_name: e for e in entries}
        on_card = self.device.type == "cuda" and \
            any(d >= 0 for d in response.devices)
        aligned = []
        for name, n in zip(response.tensor_names, response.tensor_sizes):
            if name in by_name:
                aligned.append(by_name[name])
                continue
            zeros = torch.zeros(n, dtype=response.tensor_type.to_torch(),
                                device=self.device if on_card else "cpu")
            device, ready_event, ready_stream = self._stage_tensor(zeros)
            aligned.append(TensorTableEntry(
                tensor_name=name, tensor=zeros, device=device,
                prescale_factor=response.prescale_factor,
                postscale_factor=response.postscale_factor,
                ready_event=ready_event, ready_stream=ready_stream))
        return aligned

    def _release_join(self) -> None:
        event, self.join_event = self.join_event, None
        if event is not None:
            event.set()

    def _finalizer_loop(self) -> None:
        while True:
            entries = self._finalizer_queue.get()
            if entries is None:
                return
            try:
                for e in entries:
                    e.done_event.synchronize()
                status = Status.OK()
            except RuntimeError as err:
                status = Status.error(f"CUDA collective failed: {err}")
            for e in entries:
                self._fire_callback(e, status)

    @staticmethod
    def _fire_callback(e: TensorTableEntry, status: Status) -> None:
        try:
            e.callback(status, e)
        except Exception:  # noqa: BLE001 — a raising callback must not kill
            # the thread that fires the others
            log.error("callback for %r raised", e.tensor_name, exc_info=True)

    def _fail_all_pending(self, msg: str) -> None:
        # Close first: an add racing the drain must fail fast, not strand.
        self.tensor_queue.close()
        for name in self.tensor_queue.names():
            entry = self.tensor_queue.remove(name)
            if entry is not None:
                self._fire_callback(entry, Status.error(msg))
        # A thread blocked in join() must not wait forever either.
        self._release_join()

    # ------------------------------------------------------------------
    # framework-facing enqueue API (EnqueueTensor*, operations.cc:942-1170)
    # ------------------------------------------------------------------

    def _stage_tensor(self, tensor: torch.Tensor) -> Tuple[int, object, object]:
        """(device index, ready event, caller stream).  A CUDA tensor stays
        on its card; the ready event, recorded on the caller's current
        stream, is what the op's stream waits on before reading it."""
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(tensor)!r}")
        if tensor.device.type == "cpu":
            return -1, None, None
        if tensor.device != self.device:
            raise HorovodInternalError(
                f"tensor on {tensor.device}, but this rank's runtime runs on "
                f"{self.device}")
        stream = torch.cuda.current_stream(tensor.device)
        event = torch.cuda.Event()
        event.record(stream)
        return tensor.device.index, event, stream

    def _check_initialized(self) -> None:
        if not self.initialized.is_set() or self.topo is None:
            raise HorovodInternalError(
                "horovod_tpu_torch has not been initialized; call hvd.init() "
                "first.")
        if self.async_error is not None:
            raise HorovodInternalError(self.async_error)
        if self.shutdown_complete.is_set() or \
                (self.background is not None and not self.background.is_alive()):
            raise HorovodInternalError(
                "Horovod background loop is not running (shut down or "
                "failed); reinitialize before submitting collectives")

    def _enqueue(self, name: str, tensor: torch.Tensor,
                 callback: Callable[[Status, TensorTableEntry], None],
                 request_type: RequestType,
                 output: Optional[torch.Tensor] = None, **fields) -> None:
        """Queue a named tensor's entry and its request; ``fields`` (scale
        factors, root rank, splits) go into both."""
        self._check_initialized()
        device, ready_event, ready_stream = self._stage_tensor(tensor)
        entry = TensorTableEntry(
            tensor_name=name, tensor=tensor, output=output, callback=callback,
            request_type=request_type, device=device,
            ready_event=ready_event, ready_stream=ready_stream, **fields)
        req = Request(
            request_rank=self.topo.rank, request_type=request_type,
            tensor_name=name, tensor_type=DataType.from_torch(tensor.dtype),
            tensor_shape=list(tensor.shape), device=device, **fields)
        self.tensor_queue.add(entry, req)

    def enqueue_allreduce(self, name: str, tensor: torch.Tensor,
                          callback: Callable[[Status, TensorTableEntry], None],
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          output: Optional[torch.Tensor] = None,
                          op: RequestType = RequestType.ALLREDUCE) -> None:
        """Queue a named allreduce (``op`` ALLREDUCE, the sum, or ADASUM);
        ``output`` is where the result goes (the input itself for the
        in-place flavors)."""
        self._enqueue(name, tensor, callback, op, output,
                      prescale_factor=prescale_factor,
                      postscale_factor=postscale_factor)

    def enqueue_broadcast(self, name: str, tensor: torch.Tensor,
                          root_rank: int,
                          callback: Callable[[Status, TensorTableEntry], None],
                          output: Optional[torch.Tensor] = None) -> None:
        """Queue a named broadcast from ``root_rank``; ``output`` as for
        :meth:`enqueue_allreduce`."""
        self._enqueue(name, tensor, callback, RequestType.BROADCAST, output,
                      root_rank=root_rank)

    def enqueue_allgather(self, name: str, tensor: torch.Tensor,
                          callback: Callable[[Status, TensorTableEntry], None]
                          ) -> None:
        """Queue a named allgather along the first dimension (a 0-d
        tensor counts as one row)."""
        if tensor.dim() == 0:
            tensor = tensor.reshape(1)
        self._enqueue(name, tensor, callback, RequestType.ALLGATHER)

    def enqueue_alltoall(self, name: str, tensor: torch.Tensor,
                         splits: Optional[List[int]],
                         callback: Callable[[Status, TensorTableEntry], None]
                         ) -> None:
        """Queue a named alltoall: ``splits[r]`` rows go to rank r (equal
        shares when None)."""
        self._check_initialized()
        if tensor.dim() == 0:
            tensor = tensor.reshape(1)
        if splits is None:
            if tensor.shape[0] % self.topo.size != 0:
                raise ValueError(
                    f"alltoall first dim {tensor.shape[0]} not divisible by "
                    f"size {self.topo.size}; pass explicit splits")
            splits = [tensor.shape[0] // self.topo.size] * self.topo.size
        self._enqueue(name, tensor, callback, RequestType.ALLTOALL,
                      splits=[int(n) for n in splits])

    def enqueue_join(self) -> threading.Event:
        """This rank is done with its data: it contributes zeros until every
        rank has joined (``EnqueueJoin``, ``operations.cc:1146-1170``).  The
        event is set then; at size 1 at once."""
        self._check_initialized()
        event = threading.Event()
        if self.topo.size == 1:
            event.set()
            return event
        self.join_event = event
        try:
            # JOIN carries no entry: its request goes in alone.
            self.tensor_queue.push_message(Request(
                request_rank=self.topo.rank, request_type=RequestType.JOIN,
                tensor_name=JOIN_TENSOR_NAME))
        except HorovodInternalError:
            self.join_event = None
            raise
        return event

    def enqueue_barrier(self, callback: Callable[[Status, TensorTableEntry],
                                                 None],
                        name: Optional[str] = None) -> None:
        """Queue a barrier: its callback fires once every rank (or joined
        rank) has reached it."""
        self._check_initialized()
        name = name or BARRIER_TENSOR_NAME
        self.tensor_queue.add(
            TensorTableEntry(tensor_name=name, callback=callback,
                             request_type=RequestType.BARRIER),
            Request(request_rank=self.topo.rank,
                    request_type=RequestType.BARRIER, tensor_name=name))

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        """Graceful shutdown (``horovod_shutdown``, ``operations.cc:752-778``)."""
        if not self.initialized.is_set() or self.shutdown_complete.is_set():
            return
        self.shutdown_requested.set()
        self._wake.set()
        self.shutdown_complete.wait(timeout=60)
        atexit.unregister(self.shutdown)


_global_state = HorovodGlobalState()


def global_state() -> HorovodGlobalState:
    return _global_state


def reset_global_state() -> HorovodGlobalState:
    """Shut down and replace the runtime (``hvd.shutdown`` + re-init path)."""
    global _global_state
    _global_state.shutdown()
    _global_state = HorovodGlobalState()
    return _global_state
