"""Serving requests + typed admission errors (L6 serving).

The port of nnstreamer_tpu's ``serving/request.py``: pure Python, with
torch tensors keyed like numpy arrays in ``bucket_key``.

A :class:`Request` is one client submission travelling through the
continuous-batching scheduler (``serving/scheduler.py``): admission →
priority queue → batch formation → device execution → completion. Every
request carries its own observability record (``metrics``) — enqueue
time, batch id, shape bucket, queue wait, device time, ttft and total
latency — the per-request half of ``serving.metrics_snapshot()``.

Hermes (arxiv 2409.04249) frames scheduling/batch-formation policy, not
kernel speed, as the utilization lever for streaming inference; the
typed-shedding contract here is the admission-control half of that: a
request the system cannot serve within budget fails FAST with a typed
error instead of rotting in an unbounded buffer.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Optional, Sequence, Tuple


class ServingError(RuntimeError):
    """Base class for serving-subsystem errors."""


class AdmissionError(ServingError):
    """The request was rejected/shed and NEVER executed — admission
    control (queue depth / deadline budget) refused it. Typed so callers
    can distinguish shedding from execution failure and retry elsewhere
    or degrade gracefully."""


class QueueFullError(AdmissionError):
    """Queue depth is at ``max_depth`` — the server is saturated."""


class DeadlineExceededError(AdmissionError):
    """The deadline is unmeetable: already expired at admission, expired
    while queued, or the estimated queue wait exceeds the remaining
    budget (predictive shed — reject NOW rather than execute a result
    nobody will read)."""


class MemoryPressureError(AdmissionError):
    """Admitting this request's tensors would push projected serving
    memory past the configured watermark (``obs.memory.AdmissionGuard``)
    — shed NOW, typed, instead of OOM-ing a formed batch mid-execution
    and failing every coalesced neighbor with it."""


class OverloadShedError(AdmissionError):
    """The serving plane is at capacity and cannot grow (replica ceiling
    reached or memory headroom forbids another replica —
    ``service/autoscaler.py``), so requests at or below the armed
    priority cutoff are refused immediately with THIS typed error
    instead of queueing into a p99 collapse for everyone. Higher-priority
    traffic keeps flowing; callers see a deliberate shed they can back
    off from, never a timeout."""


class SchedulerClosedError(ServingError):
    """Submission after ``close()``."""


_req_counter = itertools.count()


class Request:
    """One unit of work: ``tensors`` (leading axis = rows to batch over),
    a priority (LOWER sorts first), an optional absolute deadline
    (``time.monotonic`` seconds), and a completion future.

    For decode-mode scheduling (``DecodeScheduler``) ``tensors[0]`` is a
    1-D int32 prompt and ``steps`` bounds generation length.
    """

    __slots__ = (
        "id", "tensors", "priority", "deadline", "steps", "eos_id",
        "metrics", "on_done", "_event", "_result", "_error", "tokens",
        "trace", "_span",
    )

    def __init__(self, tensors: Sequence, priority: int = 0,
                 deadline: Optional[float] = None, steps: int = 0,
                 eos_id: Optional[int] = None,
                 on_done: Optional[Callable[["Request"], None]] = None,
                 trace=None):
        self.id = next(_req_counter)
        self.tensors = tuple(tensors)
        self.priority = priority
        self.deadline = deadline
        self.steps = steps
        self.eos_id = eos_id
        self.on_done = on_done
        self.metrics: dict = {"enqueue_time": time.monotonic()}
        self._event = threading.Event()
        self._result: Optional[Tuple] = None
        self._error: Optional[BaseException] = None
        self.tokens: list = []  # decode mode: tokens emitted so far
        # request-scoped tracing (obs/context.py): the TraceContext this
        # request belongs to — propagated from the caller (query wire,
        # tensor_serving element) or minted at admission; batch spans
        # LINK to it (a coalesced batch serves N requests, so strict
        # parentage would be a lie)
        self.trace = trace
        self._span = None  # live admission span, ended by _finish

    # -- rows ---------------------------------------------------------------
    @property
    def rows(self) -> int:
        """Rows this request contributes to a batch (leading dim; a
        dimensionless scalar counts as one row)."""
        t = self.tensors[0]
        shape = getattr(t, "shape", ())
        return int(shape[0]) if shape else 1

    def bucket_key(self) -> tuple:
        """Requests coalesce only when their per-row signature matches —
        same trailing shape and dtype for every tensor (padding rows to a
        bucket then never shows the model a fresh shape). A numpy array
        and a torch tensor of one dtype key alike (``uint8`` either way),
        and so do two devices: the batch stacks them on one."""
        return tuple(
            (tuple(getattr(t, "shape", ())[1:]),
             str(getattr(t, "dtype", "")).replace("torch.", ""))
            for t in self.tensors)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)

    # -- completion ---------------------------------------------------------
    def _finish(self) -> None:
        self.metrics.setdefault(
            "total_latency_s",
            time.monotonic() - self.metrics["enqueue_time"])
        if self._span is not None:
            self._span.end(
                "ok" if self._error is None
                else f"error:{type(self._error).__name__}")
            self._span = None
        self._event.set()
        if self.on_done is not None:
            try:
                self.on_done(self)
            except Exception:  # noqa: BLE001 - a callback must not kill the loop
                from ..utils.log import logger

                logger.exception("serving: on_done callback failed for "
                                 "request %d", self.id)

    def complete(self, result: Tuple) -> None:
        self._result = result
        self._finish()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._finish()

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None) -> Tuple:
        """Block until the scheduler completes/sheds this request; returns
        the output tensors or raises the typed error that ended it."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"serving request {self.id} not completed in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result
