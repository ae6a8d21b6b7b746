"""Priority request queue with admission control (L6 serving).

The port of nnstreamer_tpu's ``serving/queue.py``, unchanged: pure Python
over the port's named locks (analysis/sanitizer.py).

Own design (no reference analog — the reference's only buffering is the
unbounded GstQueue): a bounded priority queue that REFUSES work it cannot
serve within budget. Three admission gates, each a typed error
(``serving/request.py``):

* depth — ``max_depth`` pending requests → :class:`QueueFullError`;
* expired deadline at admission → :class:`DeadlineExceededError`;
* predictive — estimated wait (EWMA of batch service time × queue depth
  ahead, normalized by batch capacity) exceeds the request's remaining
  deadline budget → :class:`DeadlineExceededError` NOW instead of
  executing a result nobody will read;
* overload — when an external controller (the autoscaler at its replica
  ceiling — ``service/autoscaler.py``) has armed
  :meth:`~RequestQueue.set_overload`, requests whose priority is at or
  past the cutoff → :class:`OverloadShedError` (graceful degradation:
  the lowest classes shed typed, the rest keep their p99).

Expired requests still in the queue are shed at pop time (they are
completed with the typed error, never silently dropped).
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import List, Optional, Tuple

from ..analysis.sanitizer import named_condition, named_lock
from .request import (
    DeadlineExceededError,
    OverloadShedError,
    QueueFullError,
    Request,
)

_tiebreak = itertools.count()


class RequestQueue:
    """Thread-safe bounded priority queue (lower ``priority`` first, FIFO
    within a priority level)."""

    def __init__(self, max_depth: int = 256,
                 est_batch_rows: int = 8,
                 predictive_shed: bool = True,
                 on_shed=None):
        if max_depth < 1:
            raise ValueError(f"max_depth={max_depth} must be >= 1")
        self.max_depth = max_depth
        self.est_batch_rows = max(1, est_batch_rows)
        self.predictive_shed = predictive_shed
        # called (outside the lock) for each request shed at POP time —
        # admission-time sheds raise at the caller instead, so this is
        # the owning scheduler's only signal to account them
        self.on_shed = on_shed
        self._lock = named_lock("RequestQueue._lock")
        self._not_empty = named_condition("RequestQueue._not_empty",
                                          lock=self._lock)
        self._heap: List[Tuple[int, int, Request]] = []  # guarded-by: _lock
        # EWMA of one batch's service time
        self._service_ewma_s = 0.0  # guarded-by: _lock
        # overload cutoff: requests with priority >= this are refused
        # (None = disarmed). Armed/cleared by the autoscaler when the
        # replica set cannot grow past the ceiling.
        self._overload_min_priority: Optional[int] = None  # guarded-by: _lock
        self.shed_full = 0      # guarded-by: _lock
        self.shed_deadline = 0  # guarded-by: _lock
        self.shed_overload = 0  # guarded-by: _lock

    # -- overload hook -------------------------------------------------------
    def set_overload(self, min_priority: int) -> None:
        """Arm graceful shedding: admission refuses requests with
        ``priority >= min_priority`` (LOWER priority values are more
        important) with a typed :class:`OverloadShedError`."""
        with self._lock:
            self._overload_min_priority = int(min_priority)

    def clear_overload(self) -> None:
        with self._lock:
            self._overload_min_priority = None

    def overload_min_priority(self) -> Optional[int]:
        with self._lock:
            return self._overload_min_priority

    # -- service-time feedback ----------------------------------------------
    def observe_service_time(self, batch_s: float) -> None:
        """Scheduler feedback after each executed batch — drives the
        estimated-wait admission gate."""
        with self._lock:
            if self._service_ewma_s == 0.0:
                self._service_ewma_s = batch_s
            else:
                self._service_ewma_s += 0.2 * (batch_s - self._service_ewma_s)

    def estimated_wait_s(self) -> float:
        """Predicted time until a request admitted NOW starts executing:
        batches ahead of it (queue depth / batch capacity) × EWMA batch
        service time. 0.0 until the first batch calibrates the EWMA."""
        with self._lock:
            return self._estimated_wait_locked()

    def _estimated_wait_locked(self) -> float:
        if self._service_ewma_s == 0.0:
            return 0.0
        batches_ahead = (len(self._heap) + self.est_batch_rows - 1) \
            // self.est_batch_rows
        return batches_ahead * self._service_ewma_s

    # -- admission ----------------------------------------------------------
    def put(self, req: Request) -> None:
        """Admit or shed. Raises the typed error AND fails the request's
        future with it, so both the submitting thread and any ``on_done``
        observer see the same outcome."""
        now = time.monotonic()
        with self._lock:
            err: Optional[Exception] = None
            if (self._overload_min_priority is not None
                    and req.priority >= self._overload_min_priority):
                self.shed_overload += 1
                err = OverloadShedError(
                    f"serving at capacity: request {req.id} "
                    f"(priority {req.priority}) shed by the overload guard "
                    f"(cutoff {self._overload_min_priority})")
            elif len(self._heap) >= self.max_depth:
                self.shed_full += 1
                err = QueueFullError(
                    f"serving queue at max_depth={self.max_depth}; "
                    f"request {req.id} shed")
            elif req.expired(now):
                self.shed_deadline += 1
                err = DeadlineExceededError(
                    f"request {req.id} deadline already expired at "
                    "admission")
            elif (self.predictive_shed and req.deadline is not None
                    and now + self._estimated_wait_locked() > req.deadline):
                self.shed_deadline += 1
                err = DeadlineExceededError(
                    f"request {req.id} cannot meet its deadline: estimated "
                    f"queue wait {self._estimated_wait_locked() * 1e3:.1f}ms "
                    "exceeds the remaining budget")
            if err is None:
                heapq.heappush(self._heap,
                               (req.priority, next(_tiebreak), req))
                self._not_empty.notify()
                return
        req.fail(err)
        raise err

    # -- pop ----------------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Pop the highest-priority live request; expired entries are shed
        (completed with DeadlineExceededError) on the way. None on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        expired: List[Request] = []
        try:
            with self._not_empty:
                while True:
                    now = time.monotonic()
                    while self._heap:
                        _, _, req = self._heap[0]
                        if req.expired(now):
                            heapq.heappop(self._heap)
                            self.shed_deadline += 1
                            expired.append(req)
                            continue
                        heapq.heappop(self._heap)
                        return req
                    if deadline is None:
                        # bounded slices, not an indefinite park: a caller
                        # with no timeout still wakes to re-check (and a
                        # stop/notify can never be missed forever)
                        self._not_empty.wait(0.25)
                    else:
                        remaining = deadline - now
                        if remaining <= 0 or not self._not_empty.wait(remaining):
                            return None
        finally:
            # complete expired futures OUTSIDE the lock: on_done callbacks
            # may re-enter the queue (e.g. a retry submit)
            for req in expired:
                req.fail(DeadlineExceededError(
                    f"request {req.id} deadline expired while queued"))
                if self.on_shed is not None:
                    self.on_shed(req)

    def pop_upto(self, max_rows: int) -> List[Request]:
        """Non-blocking bulk pop: highest-priority live requests until
        their row total reaches ``max_rows`` or the queue empties — one
        lock acquisition for the whole backlog drain (the scheduler's
        batch-formation inner loop), not one per request. Expired entries
        are shed on the way, same contract as :meth:`get`."""
        out: List[Request] = []
        expired: List[Request] = []
        rows = 0
        with self._lock:
            now = time.monotonic()
            while self._heap and rows < max_rows:
                _, _, req = heapq.heappop(self._heap)
                if req.expired(now):
                    self.shed_deadline += 1
                    expired.append(req)
                    continue
                out.append(req)
                rows += req.rows
        for req in expired:
            req.fail(DeadlineExceededError(
                f"request {req.id} deadline expired while queued"))
            if self.on_shed is not None:
                self.on_shed(req)
        return out

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def drain(self) -> List[Request]:
        """Remove and return every pending request (scheduler shutdown —
        the caller fails them)."""
        with self._lock:
            pending = [r for _, _, r in self._heap]
            self._heap.clear()
            return pending
