"""Continuous-batching schedulers (L6 serving).

The port of nnstreamer_tpu's ``serving/scheduler.py``. Two loops over the
same admission/queue/bucketing machinery:

* :class:`Scheduler` — one-shot models (classification, detection, any
  ``tensor_filter``-style callable): requests coalesce into shape-bucketed
  padded batches (``batcher.py``), one model call serves many clients.
* :class:`DecodeScheduler` — iterative LM decode against a slot-based
  engine (``lm_engine.py``): new requests JOIN the running batch between
  decode steps (prefill into a free slot), finished sequences RETIRE
  early and free their slot — the Hermes/Orca-style continuous batching
  loop (arxiv 2409.04249).

Both record per-request metrics (queue wait, batch id, bucket, device
time, ttft, total) and register with ``serving.metrics_snapshot()``. The
batch path also feeds the obs plane: a sampled data-quality tap of each
batch's outputs (``obs.quality``, the ``serving:<name>`` series) and a
``batch`` span to the installed tracers (``utils.trace``), each behind
one module-global check.

The executor's **compile-count hook** keeps its meaning in an eager port:
nnstreamer_tpu's ``JitExecutor`` counts XLA traces, one per new input
signature; :class:`SignatureExecutor` counts the distinct input shape
signatures (shape and dtype of every input) the model has been called
with — the shapes a captured or compiled program would be built for — and
steady-state same-bucket traffic must hold it at one.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.buffer import as_torch
from ..obs import context as obs_context
from ..obs import flight as obs_flight
from ..obs import quality as obs_quality
from ..utils import trace
from ..utils.log import logger
from .batcher import Batch, BatchFormer
from .metrics import ServingMetrics, register_scheduler
from .queue import RequestQueue
from .request import (
    AdmissionError,
    MemoryPressureError,
    Request,
    SchedulerClosedError,
    ServingError,
)


def _tensors_nbytes(tensors) -> int:
    return sum(int(getattr(t, "nbytes", 0) or 0) for t in tensors)


def _block_ready(outputs) -> None:
    """Wait for the card to finish the batch's outputs (the device-time
    metric measures this; futures complete only once results exist).
    Host outputs are already ready."""
    devices = {o.device for o in outputs
               if isinstance(o, torch.Tensor) and o.is_cuda}
    for dev in devices:
        # nnlint: disable=NNL101 — deliberate: futures may only complete once
        # device results exist, and this wait is what the device-time metric
        # measures
        torch.cuda.synchronize(dev)


def _signature(xs) -> tuple:
    return tuple((tuple(getattr(x, "shape", ())),
                  str(getattr(x, "dtype", "")).replace("torch.", ""))
                 for x in xs)


class SignatureExecutor:
    """Runs a torch callable on the stacked batch and counts the distinct
    input signatures (shape and dtype of every input) it has seen — the
    compile-count hook of nnstreamer_tpu's ``JitExecutor``, which counts
    one XLA trace per new signature. Host arrays reach the callable as
    CPU torch tensors (zero-copy); outputs are returned as a tuple."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._seen: set = set()

    @property
    def compiles(self) -> int:
        return len(self._seen)

    def __call__(self, *xs):
        self._seen.add(_signature(xs))
        with torch.inference_mode():
            out = self.fn(*(as_torch(x) for x in xs))
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


class BackendExecutor(SignatureExecutor):
    """Route batches through an opened FilterBackend (``tensor_serving``'s
    torch backend: it moves each input to its device and runs the model
    there), counting input signatures like :class:`SignatureExecutor`."""

    def __init__(self, backend):
        super().__init__(lambda *xs: backend.invoke(list(xs)))
        self.backend = backend


class Scheduler:
    """One-shot continuous batcher: ``submit()`` from any thread; a
    single loop thread forms bucketed batches and executes them.

    ``fn`` — torch callable batching over axis 0 (wrapped in a
    :class:`SignatureExecutor`), or pass a prebuilt ``executor``.
    """

    def __init__(self, fn: Optional[Callable] = None, *,
                 executor=None,
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8),
                 max_wait_s: float = 0.005,
                 idle_linger_s: float = 0.0005,
                 max_depth: int = 256,
                 predictive_shed: bool = True,
                 name: str = "scheduler",
                 autostart: bool = True,
                 memory_guard=None,
                 on_close: Optional[Callable[[], None]] = None):
        if (fn is None) == (executor is None):
            raise ValueError("pass exactly one of fn= or executor=")
        self.executor = (executor if executor is not None
                         else SignatureExecutor(fn))
        # memory admission (obs/memory.py AdmissionGuard): projected
        # request bytes reserve against a watermark at submit and release
        # at completion — a saturated-memory server sheds typed instead
        # of OOM-ing mid-batch. None = no byte gate (default).
        self.memory_guard = memory_guard
        self.former = BatchFormer(bucket_sizes, max_wait_s,
                                  idle_linger_s=idle_linger_s)
        self.queue = RequestQueue(max_depth,
                                  est_batch_rows=self.former.max_bucket,
                                  predictive_shed=predictive_shed,
                                  on_shed=self._on_queue_shed)
        self.metrics = ServingMetrics()
        self._on_close = on_close
        self.name = register_scheduler(name, self)
        # request-latency series for the profiler/SLO plane (the name is
        # final only after registration uniquifies it)
        self.metrics.series = f"serving:{self.name}"
        self._running = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Scheduler":
        if self._thread is not None:
            return self
        self._running.set()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"serving:{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def _on_queue_shed(self, req: Request) -> None:
        """A request's deadline expired while queued (shed at pop time —
        queue.py already failed its future with the typed error)."""
        self._release_mem(req)
        self.metrics.record_shed(deadline=True)

    # -- memory admission (obs/memory.py AdmissionGuard) --------------------
    def _projected_bytes(self, req: Request) -> int:
        """What this request will hold resident if admitted (the guard's
        reservation unit). One-shot batching: its input tensors."""
        return _tensors_nbytes(req.tensors)

    def _reserve_mem(self, req: Request) -> None:
        """Reserve the request's projected bytes against the guard's
        watermark; sheds with a typed MemoryPressureError when the
        projection would cross it. No guard = no-op."""
        guard = self.memory_guard
        if guard is None:
            return
        nb = self._projected_bytes(req)
        if not guard.reserve(nb):
            err = MemoryPressureError(
                f"request {req.id} shed: projected serving memory "
                f"({guard.inflight_bytes} + {nb} bytes) would cross the "
                f"{guard.limit_bytes}-byte watermark")
            self.metrics.record_shed(memory=True)
            obs_flight.record("memory", "admission_shed",
                              {"scheduler": self.name, "request": req.id,
                               "bytes": nb})
            req.fail(err)
            raise err
        req.metrics["_mem_reserved"] = nb

    def _release_mem(self, req: Request) -> None:
        nb = req.metrics.pop("_mem_reserved", None)
        if nb is not None and self.memory_guard is not None:
            self.memory_guard.release(nb)

    def _record_done(self, req: Request, failed: bool = False) -> None:
        """Every request exit path funnels here: the memory reservation
        dies with the request, whatever killed it."""
        self._release_mem(req)
        self.metrics.record_request_done(req, failed=failed)

    def close(self) -> None:
        """Stop the loop and fail everything still pending with
        SchedulerClosedError (never silently dropped)."""
        self._closed = True
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        err = SchedulerClosedError(f"scheduler {self.name} closed")
        for req in self.queue.drain() + self.former.drain():
            req.fail(err)
            self._record_done(req, failed=True)
        if self._on_close is not None:
            self._on_close()
            self._on_close = None

    # -- submission ---------------------------------------------------------
    def submit(self, tensors: Sequence, priority: int = 0,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[[Request], None]] = None,
               trace=None) -> Request:
        """Admit a request (tensors batch over axis 0; a lower priority
        number schedules sooner; ``deadline_s`` is a relative latency
        budget). Raises a typed :class:`AdmissionError` when shed —
        admission control happens HERE, synchronously, so a saturated
        server pushes back instead of buffering unboundedly.

        ``trace`` — the caller's :class:`~...obs.context.TraceContext`
        (query wire / tensor_serving propagation); with tracing on and
        no context supplied, admission mints a fresh root span so direct
        submitters still get request-scoped traces."""
        if self._closed:
            raise SchedulerClosedError(f"scheduler {self.name} is closed")
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = Request(tensors, priority=priority, deadline=deadline,
                      on_done=on_done, trace=trace)
        if obs_context.TRACING and trace is None:
            req._span = obs_context.start_span(
                f"serving.request:{self.name}", kind="serving",
                attrs={"request_id": req.id})
            req.trace = req._span.context()
        self.metrics.record_submit()
        self._reserve_mem(req)  # raises typed MemoryPressureError on shed
        try:
            self.queue.put(req)
        except AdmissionError as e:
            from .request import DeadlineExceededError, OverloadShedError

            self._release_mem(req)
            self.metrics.record_shed(
                deadline=isinstance(e, DeadlineExceededError),
                overload=isinstance(e, OverloadShedError))
            raise
        self._fail_if_closed_after_put(req)
        return req

    def _fail_if_closed_after_put(self, req: Request) -> None:
        """close() may have drained the queue between our _closed check
        and queue.put — the request would strand forever. Re-check and
        drain again: if close ran, everything just enqueued (ours
        included) gets the same typed error close() gives."""
        if not self._closed:
            return
        err = SchedulerClosedError(f"scheduler {self.name} closed")
        stranded = self.queue.drain()
        for r in stranded:
            r.fail(err)
            self._record_done(r, failed=True)
        if req in stranded:
            raise err

    def __call__(self, tensors: Sequence, **kw) -> Tuple:
        """Convenience: submit and block for the result."""
        timeout = kw.pop("timeout", 60.0)
        return self.submit(tensors, **kw).result(timeout)

    @property
    def compile_count(self) -> int:
        """Distinct input signatures the executor has run (the
        no-recompile assertion hook; meaningful for
        SignatureExecutor)."""
        return self.executor.compiles

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["queue_depth"] = self.queue.depth()
        snap["estimated_wait_ms"] = self.queue.estimated_wait_s() * 1e3
        snap["compile_count"] = self.compile_count
        return snap

    # -- loop ---------------------------------------------------------------
    def _loop(self) -> None:
        while self._running.is_set():
            flush_in = self.former.next_flush_in()
            timeout = 0.05 if flush_in is None else min(flush_in, 0.05)
            req = self.queue.get(timeout=timeout)
            if req is not None:
                self.former.add(req)
                # bulk-drain the backlog — one loop pass forms the
                # largest batch it allows, one lock acquisition for the
                # whole drain instead of one per queued request
                short = self.former.max_bucket - self.former.pending_rows()
                if short > 0:
                    for more in self.queue.pop_upto(short):
                        self.former.add(more)
            for batch in self.former.take_ready(
                    idle=self.queue.depth() == 0):
                self._execute(batch)

    def _execute(self, batch: Batch) -> None:
        t_start = time.monotonic()
        for r in batch.requests:
            r.metrics["queue_wait_s"] = t_start - r.metrics["enqueue_time"]
            r.metrics["batch_id"] = batch.id
            r.metrics["bucket"] = batch.padded_rows
        try:
            inputs = batch.stacked_tensors()
            outputs = self.executor(*inputs)
            _block_ready(outputs)
        except Exception as e:  # noqa: BLE001 - must fail futures, not the loop
            err = e if isinstance(e, ServingError) else ServingError(
                f"batch {batch.id} execution failed: {e}")
            logger.exception("serving %s: batch %d failed", self.name,
                             batch.id)
            obs_flight.record("serving", "batch_failed",
                              {"scheduler": self.name, "batch": batch.id,
                               "error": str(e)[:200]})
            for r in batch.requests:
                r.fail(err)
                self._record_done(r, failed=True)
            return
        device_s = time.monotonic() - t_start
        self.queue.observe_service_time(device_s)
        self.metrics.record_batch(batch.rows, batch.padded_rows, device_s)
        if obs_quality.ACTIVE:
            # data-plane health tap: sampled batch-output reduction into
            # the "serving:<scheduler>" series (one module-global check
            # when the taps are off)
            obs_quality.observe_outputs(
                f"serving:{self.name}",
                outputs if isinstance(outputs, (list, tuple))
                else (outputs,))
        if trace.ACTIVE:
            trace.notify_serving(
                "batch", self.name, t_start, device_s,
                {"batch_id": batch.id, "rows": batch.rows,
                 "bucket": batch.padded_rows})
        if obs_context.TRACING:
            # one batch span LINKED to every member request's span — the
            # batch has N parents, which links express and strict
            # parentage cannot (docs/observability.md)
            links = [r.trace for r in batch.requests if r.trace is not None]
            obs_context.record_span(
                f"batch:{self.name}", kind="serving",
                trace_id=links[0].trace_id if links else None,
                links=links, start_s=t_start, dur_s=device_s,
                attrs={"batch_id": batch.id, "rows": batch.rows,
                       "bucket": batch.padded_rows})
        now = time.monotonic()
        for r, outs in zip(batch.requests, batch.split_outputs(outputs)):
            r.metrics["device_time_s"] = device_s
            r.metrics["ttft_s"] = now - r.metrics["enqueue_time"]
            r.metrics.setdefault("total_latency_s",
                                 now - r.metrics["enqueue_time"])
            # record BEFORE complete(): complete() releases the waiter
            # (and the query-bridge answer), so a client must never see
            # its answer while the completed counter still excludes it
            self._record_done(r)
            r.complete(outs)
        # these clients just got results — closed-loop traffic resubmits
        # within the next max-wait window, so hold the idle-boundary
        # flush until that many rows land (or the window lapses) rather
        # than fragmenting the incoming burst into batch-of-1 flushes
        self.former.expect(batch.rows, self.former.max_wait_s)


class DecodeScheduler:
    """Continuous-batching loop for iterative decode: a fixed-slot engine
    steps ALL active sequences in one compiled call; requests join
    between steps (prefill into a free slot) and retire the moment they
    finish (max steps or ``eos_id``), freeing the slot for the next
    queued request — no drain barrier between batches.

    The engine contract (``lm_engine.ContinuousLMEngine`` implements it):

    * ``slots`` — fixed batch capacity;
    * ``admit(slot, tokens, steps) -> int`` — prefill; returns the first
      generated token;
    * ``step() -> np.ndarray (slots,)`` — one decode step over every
      slot (inactive slots compute garbage; the loop ignores them);
    * ``release(slot)`` — slot freed (optional);
    * ``compile_count`` — optional compile hook.

    Optional extensions the paged/speculative engines provide
    (``lm_engine.PagedLMEngine`` / ``speculative.SpeculativeLMEngine``):

    * ``admit_start``/``prefill_tick`` — chunked prefill: admit queues
      the prompt, the loop ingests ONE bounded chunk per pass, so a
      long prompt interleaves with running decode instead of stalling
      the batch;
    * ``step_tokens() -> list[list[int]]`` — burst decode (speculative
      rounds emit 1..K tokens per slot per pass);
    * ``preempt(slot) -> blob``/``restore(slot, blob)`` — deadline-aware
      memory pressure: on ``PagePoolExhausted`` the loop evicts the
      victim with the MOST deadline slack to host and requeues it;
      readmission restores byte-exact — the request is never dropped;
    * ``projected_page_bytes(tokens, steps)`` — the AdmissionGuard
      reserves page-pool bytes instead of dense tensor bytes.

    Page-release invariant: EVERY request exit path — normal retire,
    deadline shed (queued or mid-decode), batch failure, close — goes
    through ``engine.release(slot)``, so page refcounts reach zero
    whatever killed the request (asserted by the NNS_LEAKCHECK ledger).
    """

    def __init__(self, engine, *,
                 max_depth: int = 256,
                 predictive_shed: bool = True,
                 name: str = "decode",
                 autostart: bool = True,
                 memory_guard=None):
        self.engine = engine
        self.memory_guard = memory_guard  # see Scheduler.memory_guard
        self.queue = RequestQueue(max_depth, est_batch_rows=engine.slots,
                                  predictive_shed=predictive_shed,
                                  on_shed=self._on_queue_shed)
        self.metrics = ServingMetrics()
        self.name = register_scheduler(name, self)
        self.metrics.series = f"serving:{self.name}"
        self._active: Dict[int, Request] = {}
        self._prefilling: Dict[int, Request] = {}  # chunked-prefill slots
        self._free: List[int] = list(range(engine.slots))[::-1]
        self._running = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "DecodeScheduler":
        if self._thread is not None:
            return self
        self._running.set()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"serving:{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        err = SchedulerClosedError(f"scheduler {self.name} closed")
        # in-flight slots MUST release through the engine (page-release
        # invariant: close is an exit path like any other — without this
        # the pool leaks every page a live request held at shutdown)
        for slot in list(self._active) + list(self._prefilling):
            req = self._active.pop(slot, None) or \
                self._prefilling.pop(slot, None)
            if req is not None:
                req.fail(err)
                self._record_done(req, failed=True)
            self._retire_slot_only(slot)
        for req in self.queue.drain():
            req.fail(err)
            self._record_done(req, failed=True)
        close = getattr(self.engine, "close", None)
        if close is not None:
            close()  # paged engine: drop the prefix registry's page refs

    # -- submission ---------------------------------------------------------
    def submit(self, tokens, steps: int, priority: int = 0,
               deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               on_done: Optional[Callable[[Request], None]] = None,
               trace=None) -> Request:
        """Queue a prompt (1-D int32) for up to ``steps`` generated
        tokens (fewer when ``eos_id`` appears). The result tuple holds
        one (n,) int32 array of generated tokens."""
        if self._closed:
            raise SchedulerClosedError(f"scheduler {self.name} is closed")
        if steps < 1:
            raise ValueError(f"steps={steps} must be >= 1")
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(
                f"decode prompt must be 1-D tokens, got shape {tokens.shape}")
        validate = getattr(self.engine, "validate", None)
        if validate is not None:
            validate(tokens, steps)  # fail fast (e.g. prompt+steps > max_seq)
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = Request((tokens,), priority=priority, deadline=deadline,
                      steps=steps, eos_id=eos_id, on_done=on_done,
                      trace=trace)
        if obs_context.TRACING and trace is None:
            req._span = obs_context.start_span(
                f"serving.request:{self.name}", kind="serving",
                attrs={"request_id": req.id})
            req.trace = req._span.context()
        self.metrics.record_submit()
        self._reserve_mem(req)  # raises typed MemoryPressureError on shed
        try:
            self.queue.put(req)
        except AdmissionError as e:
            from .request import DeadlineExceededError, OverloadShedError

            self._release_mem(req)
            self.metrics.record_shed(
                deadline=isinstance(e, DeadlineExceededError),
                overload=isinstance(e, OverloadShedError))
            raise
        self._fail_if_closed_after_put(req)
        return req

    _on_queue_shed = Scheduler._on_queue_shed
    _fail_if_closed_after_put = Scheduler._fail_if_closed_after_put
    _reserve_mem = Scheduler._reserve_mem
    _release_mem = Scheduler._release_mem
    _record_done = Scheduler._record_done

    def _projected_bytes(self, req: Request) -> int:
        """Paged engines reserve PAGES (what the request will actually
        pin in the pool), not dense tensor bytes — the AdmissionGuard
        gate matches the resource that can actually run out."""
        projected = getattr(self.engine, "projected_page_bytes", None)
        if projected is not None and req.steps:
            return projected(int(req.tensors[0].size), int(req.steps))
        return _tensors_nbytes(req.tensors)

    @property
    def compile_count(self) -> int:
        return getattr(self.engine, "compile_count", 0)

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["queue_depth"] = self.queue.depth()
        snap["estimated_wait_ms"] = self.queue.estimated_wait_s() * 1e3
        snap["active_slots"] = len(self._active)
        snap["slots"] = self.engine.slots
        snap["compile_count"] = self.compile_count
        pool = getattr(self.engine, "pool", None)
        if pool is not None:
            snap["kv_pool"] = pool.stats()
        rate = getattr(self.engine, "acceptance_rate", None)
        if rate is not None:
            snap["spec_acceptance_rate"] = rate()
            snap["spec_rounds"] = self.engine.spec_rounds
            snap["spec_proposed"] = self.engine.spec_proposed
            snap["spec_accepted"] = self.engine.spec_accepted
        return snap

    # -- loop ---------------------------------------------------------------
    def _admit_one(self, req: Request) -> bool:
        """Place a request into a free slot: restore a preempted one,
        queue a chunked prefill, or run the blocking admit. Returns
        False when the pool cannot take it YET (request requeued; stop
        admitting this pass)."""
        from .kv_pool import PagePoolExhausted

        slot = self._free.pop()
        t0 = time.monotonic()
        req.metrics.setdefault("queue_wait_s",
                               t0 - req.metrics["enqueue_time"])
        blob = req.metrics.pop("_preempt_blob", None)
        if blob is not None:
            try:
                self.engine.restore(slot, blob)
            except PagePoolExhausted:
                # still too tight: keep it queued, blob intact
                self._free.append(slot)
                req.metrics["_preempt_blob"] = blob
                self._requeue(req)
                return False
            except Exception as e:  # noqa: BLE001 - engine rejected restore
                self._free.append(slot)
                req.fail(e if isinstance(e, ServingError)
                         else ServingError(f"decode restore failed: {e}"))
                self._record_done(req, failed=True)
                return True
            req.metrics["slot"] = slot
            self._active[slot] = req
            self.metrics.record_restore()
            obs_flight.record("memory", "preempt_restore",
                              {"scheduler": self.name, "request": req.id,
                               "slot": slot})
            return True
        if getattr(self.engine, "admit_start", None) is not None:
            try:
                self.engine.admit_start(slot, req.tensors[0], req.steps)
            except PagePoolExhausted:
                self._free.append(slot)
                if not self._preempt_victim():
                    self._fail_mem(req)
                else:
                    self._requeue(req)
                return False
            except Exception as e:  # noqa: BLE001 - engine rejected prompt
                self._free.append(slot)
                req.fail(e if isinstance(e, ServingError)
                         else ServingError(f"decode admit failed: {e}"))
                self._record_done(req, failed=True)
                return True
            req.metrics["slot"] = slot
            req.metrics["_prefill_t0"] = t0
            self._prefilling[slot] = req
            return True
        try:
            first = int(self.engine.admit(slot, req.tensors[0], req.steps))
        except Exception as e:  # noqa: BLE001 - engine rejected this prompt
            self._free.append(slot)
            req.fail(e if isinstance(e, ServingError)
                     else ServingError(f"decode admit failed: {e}"))
            self._record_done(req, failed=True)
            return True
        now = time.monotonic()
        req.metrics["slot"] = slot
        req.metrics["ttft_s"] = now - req.metrics["enqueue_time"]
        req.metrics["prefill_s"] = now - t0
        req.tokens.append(first)
        if self._finished(req, first):
            self._retire(slot, req, early=False)
        else:
            self._active[slot] = req
        return True

    def _requeue(self, req: Request) -> None:
        """Put a preempted/deferred request back in line; if the queue
        itself sheds it, the failure is typed like any admission shed."""
        try:
            self.queue.put(req)
        except AdmissionError as e:
            from .request import DeadlineExceededError

            self.metrics.record_shed(
                deadline=isinstance(e, DeadlineExceededError))
            req.fail(e)
            self._record_done(req, failed=True)

    def _fail_mem(self, req: Request) -> None:
        err = MemoryPressureError(
            f"request {req.id} shed: KV page pool exhausted and no "
            "preemptable victim (typed shed, not an OOM)")
        self.metrics.record_shed(memory=True)
        obs_flight.record("memory", "page_pool_shed",
                          {"scheduler": self.name, "request": req.id})
        req.fail(err)
        self._record_done(req, failed=True)

    def _preempt_victim(self, min_active: int = 1) -> bool:
        """Deadline-aware eviction: push the ACTIVE request with the
        most slack (no deadline beats any deadline; later beats sooner)
        to host and requeue it — never drop it. False when the engine
        cannot preempt or fewer than ``min_active`` streams are running
        (evicting the only runner to feed itself is a livelock, not
        progress — the caller sheds typed instead)."""
        preempt = getattr(self.engine, "preempt", None)
        if preempt is None or len(self._active) < min_active:
            return False
        slot = max(self._active,
                   key=lambda s: (self._active[s].deadline is None,
                                  self._active[s].deadline or 0.0))
        req = self._active.pop(slot)
        try:
            blob = preempt(slot)
        except Exception:  # noqa: BLE001 - engine state is authoritative
            logger.exception("serving %s: preempt of slot %d failed",
                             self.name, slot)
            self._active[slot] = req
            return False
        self._free.append(slot)
        req.metrics["_preempt_blob"] = blob
        self.metrics.record_preemption()
        obs_flight.record("memory", "preemption",
                          {"scheduler": self.name, "request": req.id,
                           "slot": slot,
                           "decoded": len(req.tokens)})
        self._requeue(req)
        return True

    def _finished(self, req: Request, last_token: int) -> bool:
        if len(req.tokens) >= req.steps:
            return True
        return req.eos_id is not None and last_token == req.eos_id

    def _retire(self, slot: int, req: Request, early: bool) -> None:
        self._active.pop(slot, None)
        release = getattr(self.engine, "release", None)
        if release is not None:
            release(slot)
        self._free.append(slot)
        if early:
            self.metrics.record_early_retire()
        req.metrics["decode_steps"] = len(req.tokens)
        # nnlint: disable=NNL101 — req.tokens is a host-side python list: this
        # asarray is a list→array pack, not a device sync
        req.complete((np.asarray(req.tokens, np.int32),))
        self._record_done(req)

    def _prefill_tick(self) -> None:
        """Ingest ONE prompt chunk (chunked-prefill engines): long
        prompts advance one bounded chunk per loop pass, interleaved
        with decode steps, instead of stalling the whole batch."""
        from .kv_pool import PagePoolExhausted

        # bounded retry IN THIS PASS: preempting a victim only helps if
        # the tick reclaims the freed pages before the admit phase
        # restores the victim (otherwise preempt/restore ping-pong
        # forever and the starved prompt never advances)
        done = []
        for _ in range(self.engine.slots + 1):
            try:
                done = self.engine.prefill_tick()
                break
            except PagePoolExhausted:
                if self._preempt_victim():
                    continue
                # no victim left: shed the oldest prefilling request
                # (typed, never an OOM)
                if self._prefilling:
                    slot = next(iter(self._prefilling))
                    req = self._prefilling.pop(slot)
                    self._fail_mem(req)
                    self._retire_slot_only(slot)
                return
            except Exception as e:  # noqa: BLE001 - fail that prompt, keep serving
                logger.exception("serving %s: prefill chunk failed",
                                 self.name)
                if self._prefilling:
                    slot = next(iter(self._prefilling))
                    req = self._prefilling.pop(slot)
                    req.fail(e if isinstance(e, ServingError)
                             else ServingError(f"decode prefill failed: {e}"))
                    self._record_done(req, failed=True)
                    self._retire_slot_only(slot)
                return
        now = time.monotonic()
        for slot, first in done:
            req = self._prefilling.pop(slot, None)
            if req is None:
                continue
            req.metrics["ttft_s"] = now - req.metrics["enqueue_time"]
            req.metrics["prefill_s"] = now - req.metrics.pop(
                "_prefill_t0", now)
            req.tokens.append(int(first))
            if self._finished(req, int(first)):
                self._retire(slot, req, early=False)
            else:
                self._active[slot] = req

    def _shed_expired_active(self) -> None:
        """Mid-decode deadline enforcement: a stream that cannot finish
        in time stops burning slots and steps NOW — and its exit goes
        through the engine release path like every other (pages freed)."""
        now = time.monotonic()
        for slot, req in list(self._active.items()):
            if req.deadline is not None and now > req.deadline:
                from .request import DeadlineExceededError

                req.fail(DeadlineExceededError(
                    f"request {req.id} deadline expired mid-decode "
                    f"after {len(req.tokens)} tokens"))
                self.metrics.record_shed(deadline=True)
                self._record_done(req, failed=True)
                self._retire_slot_only(slot)

    def _loop(self) -> None:
        from .kv_pool import PagePoolExhausted

        has_chunked = getattr(self.engine, "prefill_tick", None) is not None
        step_tokens = getattr(self.engine, "step_tokens", None)
        while self._running.is_set():
            # JOIN: fill free slots from the queue between decode steps —
            # block only when the whole batch is idle
            while self._free:
                busy = self._active or self._prefilling
                req = self.queue.get(timeout=0 if busy else 0.05)
                if req is None:
                    break
                if not self._admit_one(req):
                    break  # pool saturated this pass; retry next pass
            if has_chunked and self._prefilling:
                self._prefill_tick()
            if not self._active:
                continue
            self._shed_expired_active()
            if not self._active:
                continue
            t0 = time.monotonic()
            toks = bursts = None
            stepped = False
            # bounded retry IN THIS PASS (same reasoning as
            # _prefill_tick): after a preemption the survivors must
            # retry the step BEFORE the admit phase restores the victim,
            # or the two sides ping-pong pages forever with zero decode
            # progress. min_active=2 — preempting the only runner to
            # feed itself is that same livelock in one slot.
            for _ in range(self.engine.slots + 1):
                try:
                    if step_tokens is not None:
                        bursts = step_tokens()  # 1..K tokens per slot
                    else:
                        # nnlint: disable=NNL101 — the decode loop's one
                        # designed pull: (slots,) tokens must reach the
                        # host to route/retire
                        toks = np.asarray(self.engine.step())
                    stepped = True
                    break
                except PagePoolExhausted:
                    # a running stream crossed into a page the pool
                    # cannot supply: evict the slackest victim and retry
                    # now; if nothing is preemptable the starved stream
                    # sheds typed rather than OOM-ing the device
                    if self._preempt_victim(min_active=2):
                        continue
                    if self._active:
                        slot = next(iter(self._active))
                        req = self._active.pop(slot)
                        self._fail_mem(req)
                        self._retire_slot_only(slot)
                    break
                except Exception as e:  # noqa: BLE001 - fail batch, keep serving
                    err = ServingError(f"decode step failed: {e}")
                    logger.exception("serving %s: decode step failed",
                                     self.name)
                    for slot, req in list(self._active.items()):
                        req.fail(err)
                        self._record_done(req, failed=True)
                        self._retire_slot_only(slot)
                    break
            if not stepped:
                continue
            device_s = time.monotonic() - t0
            self.queue.observe_service_time(device_s)
            self.metrics.record_decode_step(len(self._active),
                                            self.engine.slots, device_s)
            for slot, req in list(self._active.items()):
                burst = ([int(toks[slot])] if bursts is None
                         else [int(t) for t in bursts[slot]])
                req.metrics["device_time_s"] = \
                    req.metrics.get("device_time_s", 0.0) + device_s
                for tok in burst:
                    req.tokens.append(tok)
                    if self._finished(req, tok):
                        # RETIRE early: the slot frees this step, not at
                        # the end of the longest sequence in the batch —
                        # surplus burst tokens past eos/steps are
                        # dropped (cache-consistent: commit already
                        # advanced past them)
                        self._retire(slot, req,
                                     early=len(req.tokens) < req.steps)
                        break

    def _retire_slot_only(self, slot: int) -> None:
        self._active.pop(slot, None)
        release = getattr(self.engine, "release", None)
        if release is not None:
            release(slot)
        self._free.append(slot)
