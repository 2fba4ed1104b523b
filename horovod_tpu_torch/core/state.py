"""Global runtime state and the background coordination loop.

Counterpart of ``horovod_tpu/core/state.py`` (the reference's
``HorovodGlobalState`` + ``BackgroundThreadLoop`` / ``RunLoopOnce``,
``operations.cc:117, 361-689``, and the ``Enqueue*`` entry points,
``operations.cc:942-1170``): a singleton owning the topology, the
controller, the tensor queue and the op chain; a background thread that
wakes every cycle, runs one negotiation round and executes the agreed
responses; framework threads enqueue named tensors with callbacks.

Device work completes on a finalizer thread: an op that queued CUDA work
returns ``Status.in_progress()`` and the finalizer waits on the op's CUDA
event before firing the entries' callbacks (reference
``gpu_operations.h:98-127``), so the loop moves straight on to the next
cycle.  This runtime runs one process; several ranks need the transport
slice (ROADMAP.md).
"""

from __future__ import annotations

import atexit
import queue
import threading
import time
from typing import Callable, Optional, Tuple

import torch

from ..backend.cuda import CudaAllreduce
from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError
from ..common.logging_util import get_logger
from ..common.topology import ProcessTopology, from_env
from .controller import Controller
from .messages import DataType, Request, RequestType, Response, ResponseType
from .operation_manager import OperationManager
from .tensor_queue import Status, TensorQueue, TensorTableEntry

log = get_logger("horovod_tpu_torch.state")


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
        # Enqueues set this event so an idle loop wakes at once instead of
        # sleeping out the cycle; busy cycles skip the sleep entirely.
        self._wake = threading.Event()
        self._last_cycle_had_work = False
        self._finalizer_queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._finalizer: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def initialize(self, device: torch.device,
                   topology: Optional[ProcessTopology] = None) -> None:
        """``InitializeHorovodOnce`` analog (``operations.cc:693-739``):
        spawn the background thread, block until the controller is up."""
        if self.initialized.is_set():
            return
        topo = topology or from_env()
        if topo.size > 1:
            raise HorovodInternalError(
                f"size {topo.size} requested, but this runtime runs one "
                "process: cross-rank negotiation and the NCCL allreduce "
                "arrive with the transport slice (ROADMAP.md, queue A)")
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

    def _build(self) -> None:
        """The one-process part of ``_build_transport`` and
        ``_register_default_ops``: controller, op chain, finalizer."""
        fusion = env_mod.get_int(
            env_mod.HOROVOD_FUSION_THRESHOLD, env_mod.DEFAULT_FUSION_THRESHOLD)
        stall_secs = 0 if env_mod.get_bool(env_mod.HOROVOD_STALL_CHECK_DISABLE) \
            else env_mod.get_float(env_mod.HOROVOD_STALL_CHECK_TIME_SECONDS,
                                   env_mod.DEFAULT_STALL_CHECK_TIME_SECONDS)
        self.controller = Controller(
            self.topo, fusion_threshold_bytes=fusion,
            stall_warning_secs=stall_secs,
            stall_shutdown_secs=env_mod.get_float(
                env_mod.HOROVOD_STALL_SHUTDOWN_TIME_SECONDS,
                env_mod.DEFAULT_STALL_SHUTDOWN_TIME_SECONDS))
        self.op_manager.register(ResponseType.ALLREDUCE,
                                 CudaAllreduce(self.topo, self.device))
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
            self._fail_all_pending(f"Horovod background loop died: {e}")
        else:
            self._fail_all_pending("Horovod has been shut down")
        finally:
            # In-flight device work completes (and fires its callbacks)
            # before shutdown is declared done.
            self._finalizer_queue.put(None)
            self._finalizer.join(timeout=60)
            self.shutdown_complete.set()

    def _run_loop_once(self) -> bool:
        """One cycle (``RunLoopOnce``, ``operations.cc:595-689``): negotiate,
        then execute every agreed response.  Returns False to stop."""
        requests = self.tensor_queue.pop_messages()
        response_list = self.controller.compute_response_list(
            requests, self.shutdown_requested.is_set())
        self._last_cycle_had_work = bool(requests) \
            or bool(response_list.responses)
        for response in response_list.responses:
            self._perform_operation(response)
        return not response_list.shutdown

    def _perform_operation(self, response: Response) -> None:
        """``PerformOperation`` analog (``operations.cc:256-336``)."""
        entries = self.tensor_queue.get_entries_for_response(response)
        if response.response_type == ResponseType.ERROR:
            for e in entries:
                self._fire_callback(e, Status.error(response.error_message))
            return
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
                status = Status.error(f"CUDA allreduce failed: {err}")
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
        if self.shutdown_complete.is_set() or \
                (self.background is not None and not self.background.is_alive()):
            raise HorovodInternalError(
                "Horovod background loop is not running (shut down or "
                "failed); reinitialize before submitting collectives")

    def enqueue_allreduce(self, name: str, tensor: torch.Tensor,
                          callback: Callable[[Status, TensorTableEntry], None],
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0,
                          output: Optional[torch.Tensor] = None) -> None:
        """Queue a named allreduce; ``output`` is where the result goes
        (the input itself for the in-place flavors)."""
        self._check_initialized()
        device, ready_event, ready_stream = self._stage_tensor(tensor)
        entry = TensorTableEntry(
            tensor_name=name, tensor=tensor, output=output, callback=callback,
            request_type=RequestType.ALLREDUCE, device=device,
            prescale_factor=prescale_factor, postscale_factor=postscale_factor,
            ready_event=ready_event, ready_stream=ready_stream)
        req = Request(
            request_rank=self.topo.rank, request_type=RequestType.ALLREDUCE,
            tensor_name=name, tensor_type=DataType.from_torch(tensor.dtype),
            tensor_shape=list(tensor.shape), device=device,
            prescale_factor=prescale_factor, postscale_factor=postscale_factor)
        self.tensor_queue.add(entry, req)

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
