"""Pipeline-less single-shot inference API (L6).

The counterpart of nnstreamer_tpu's ``single.py``. Reference analog:
``tensor_filter_single`` (gst/nnstreamer/tensor_filter/tensor_filter_single.c
— the GObject wrapper the ML-Service C API's ``ml_single_open``/
``ml_single_invoke`` uses to run a model with no pipeline), PLUS the
ml_single-layer guarantees that wrapper is consumed through (ml-api
``ml_single_set_timeout`` / ``ml_single_invoke`` semantics): invokes are
serialized on one worker, a timeout turns a wedged invoke into an error
instead of a hang, a timed-out invoke's late result is discarded (never
returned to a later call), and inputs are validated against the model's
declared info before dispatch. Usage::

    with SingleShot("torch", "builtin://scaler?factor=2",
                    accelerator="cpu") as s:
        out = s.invoke(np.ones((2, 2), np.float32))

    s = SingleShot("torch", model, timeout_ms=3000)   # bounded, on cuda:0
    s.set_timeout(0)                                  # back to unbounded

The model runs on ``cuda:0`` unless ``accelerator="cpu"`` (the backend's
device rule, ``backends/torch_backend.py``). CUDA's current device and
stream are per thread, so a bounded invoke's worker runs under the
caller's: the caller's current stream on the backend's card, made
current for the call. ``share_key`` opens (or joins) the same backend
instance a ``tensor_filter shared-tensor-filter-key=`` uses.
"""
from __future__ import annotations

import queue as _queue
import threading
import weakref
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backends.base import (
    Accelerator,
    FilterProperties,
    acquire_backend,
    release_backend,
)
from .core import DataType, TensorsInfo
from .utils.log import logger
from .utils.stats import InvokeStats, Timer


def _dtype_shape(x) -> Tuple[DataType, tuple]:
    """dtype and shape of an input without moving it: a CUDA tensor is
    never pulled to the host to be checked."""
    if isinstance(x, torch.Tensor):
        return DataType.from_any(x.dtype), tuple(x.shape)
    a = np.asarray(x)
    return DataType.from_any(a.dtype), tuple(a.shape)


class SingleShot:
    def __init__(self, framework: str, model: str, custom: str = "",
                 accelerator: str = "auto", share_key: str = "",
                 timeout_ms: float = 0.0, validate: bool = True):
        self._share_key = share_key
        self.stats = InvokeStats()
        self._timeout_ms = float(timeout_ms)
        self._validate = validate
        self._worker: Optional[threading.Thread] = None
        self._requests: _queue.Queue = _queue.Queue()
        self._pending: Optional[_queue.Queue] = None  # timed-out, result due
        self.backend = acquire_backend(
            framework,
            FilterProperties(model=model, custom=custom,
                             accelerator=Accelerator(accelerator)),
            share_key,
        )

    # -- info ---------------------------------------------------------------
    @property
    def device(self) -> Optional[torch.device]:
        """The device the backend runs on."""
        return getattr(self.backend, "device", None)

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self.backend.get_model_info()

    def set_input_info(self, in_info: TensorsInfo) -> Optional[TensorsInfo]:
        return self.backend.set_input_info(in_info)

    def set_timeout(self, timeout_ms: float) -> None:
        """Bound every subsequent invoke (reference ``ml_single_set_timeout``;
        0 = wait forever)."""
        self._timeout_ms = float(timeout_ms)

    # -- validation (ml_single checks tensor count/size before dispatch) ----
    def _check_inputs(self, inputs: Sequence[Any]) -> None:
        info, _ = self.backend.get_model_info()
        if info is None or not info.specs:
            return  # flexible/self-describing model: nothing to check against
        if len(inputs) != len(info.specs):
            raise ValueError(
                f"invoke got {len(inputs)} input tensor(s), model declares "
                f"{len(info.specs)}")
        for i, (x, spec) in enumerate(zip(inputs, info.specs)):
            dt, shape = _dtype_shape(x)
            want_dt = spec.dtype
            if dt is not want_dt:
                raise TypeError(
                    f"input {i}: dtype {dt.value} != declared {want_dt.value}")
            want = tuple(spec.shape)
            if want and None not in want and shape != want:
                # rank>=2 leading dim is the batch axis: the model is
                # batch-polymorphic, so only the NON-batch dims must match
                # the declaration. A rank-1 length mismatch has no batch
                # axis to excuse it.
                if not (len(want) >= 2 and len(shape) == len(want)
                        and shape[1:] == want[1:]):
                    raise ValueError(
                        f"input {i}: shape {shape} != declared {want}")

    # -- invoke -------------------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            # the loop holds only a weakref to self: an abandoned handle
            # (no close()) must not be pinned alive forever by its own
            # worker — the thread exits when the handle is collected
            self._worker = threading.Thread(
                target=_worker_loop,
                args=(weakref.ref(self), self._requests),
                name="single-invoke", daemon=True)
            self._worker.start()

    def _clear_pending(self, wait_s: float = 0.0) -> None:
        """Discard a timed-out invoke's late result; with ``wait_s``, give
        the wedged invoke that long to land first. Raises if it is still
        running and no wait was allowed."""
        if self._pending is None:
            return
        try:
            self._pending.get(timeout=wait_s) if wait_s > 0 \
                else self._pending.get_nowait()
            self._pending = None
        except _queue.Empty:
            raise RuntimeError(
                "previous invoke timed out and is still running; "
                "wait before invoking or closing this handle")

    def _caller_stream(self) -> Optional[torch.cuda.Stream]:
        """The calling thread's current stream on the backend's card (None
        on the CPU): the worker enqueues there, as a direct call would."""
        dev = self.device
        if dev is None or dev.type != "cuda":
            return None
        return torch.cuda.current_stream(dev)

    def invoke(self, *inputs: Any, timeout_ms: Optional[float] = None) -> List[Any]:
        """Run the model. With a timeout (per-call arg or instance default,
        ms; 0 = unbounded) a wedged invoke raises TimeoutError after the
        deadline; its late result is discarded when it eventually lands
        (ml_single guarantee: a timed-out answer is never handed to a
        subsequent call)."""
        if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
            inputs = tuple(inputs[0])
        if self.backend is None:
            raise RuntimeError("SingleShot is closed")
        if self._validate:
            self._check_inputs(inputs)
        tmo = self._timeout_ms if timeout_ms is None else float(timeout_ms)
        # invokes never interleave (the reference's single handle has
        # exactly one invoke thread): EVERY path first clears a previously
        # timed-out call whose result is still owed
        self._clear_pending()
        if tmo <= 0:
            with Timer(self.stats):
                return self.backend.invoke(list(inputs))
        self._ensure_worker()
        done: _queue.Queue = _queue.Queue(1)
        timer = Timer(self.stats)
        timer.__enter__()
        self._requests.put((list(inputs), self._caller_stream(), done))
        try:
            kind, val = done.get(timeout=tmo / 1e3)
        except _queue.Empty:
            self._pending = done
            raise TimeoutError(
                f"invoke exceeded {tmo:.0f} ms (model wedged or device "
                "stalled); the late result will be discarded")
        finally:
            timer.__exit__()
        if kind == "err":
            raise val
        return val

    # -- lifecycle ----------------------------------------------------------
    def close(self, drain_timeout_s: float = 10.0) -> None:
        """Release the backend. A still-running timed-out invoke is given
        ``drain_timeout_s`` to finish first — closing a backend mid-invoke
        would free weights its kernels still read. The late result is
        dropped with the handle's last reference to it."""
        if self.backend is not None:
            try:
                self._clear_pending(wait_s=drain_timeout_s)
            except RuntimeError:
                logger.warning(
                    "SingleShot.close: a timed-out invoke is STILL running "
                    "after %.0fs; closing anyway (backend may be unsafe)",
                    drain_timeout_s)
            self._pending = None
            if self._worker is not None and self._worker.is_alive():
                self._requests.put(None)  # stop sentinel
                self._worker.join(timeout=2.0)
                self._worker = None
            release_backend(self.backend, self._share_key)
            self.backend = None

    def __enter__(self) -> "SingleShot":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _run_on(stream: Optional[torch.cuda.Stream], backend, inputs):
    """One invoke under the caller's device and stream, complete on
    return: a timeout must mean DONE, not just dispatched (a stream
    synchronize, not the whole card)."""
    if stream is None:
        return backend.invoke(inputs)
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        outs = backend.invoke(inputs)
    stream.synchronize()
    return outs


def _worker_loop(ref: "weakref.ref[SingleShot]", requests: _queue.Queue) -> None:
    """Module-level so the thread pins the handle only via a weakref."""
    while True:
        try:
            item = requests.get(timeout=5.0)
        except _queue.Empty:
            if ref() is None:  # handle abandoned without close()
                return
            continue
        if item is None:
            return
        inputs, stream, done = item
        del item
        self = ref()
        if self is None or self.backend is None:
            done.put(("err", RuntimeError("SingleShot closed mid-invoke")))
            return
        backend = self.backend
        del self  # drop the strong ref during the invoke
        try:
            done.put(("ok", _run_on(stream, backend, inputs)))
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            done.put(("err", e))
        # nothing of this request outlives it here: a late result is held
        # only by its queue, which the handle drops on clear or close
        del inputs, stream, done, backend
