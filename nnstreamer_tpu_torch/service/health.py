"""Service health: liveness/readiness probes, stall watchdog, snapshots (L7).

One :class:`HealthMonitor` thread per started service:

* **readiness promotion** — a STARTING service becomes READY when its
  warmup condition holds (caps negotiated and one inference completed
  end-to-end, observed as the first buffer rendered at a sink);
* **stall watchdog** — a READY service whose sinks stop making progress
  for ``watchdog_s`` seconds while its sources are still running is
  marked DEGRADED and handed to the supervisor (buffer loss without an
  exception is still an outage);
* **probes** — ``liveness()`` (the process half: pipeline exists and is
  playing or deliberately parked) and ``readiness()`` (serve traffic
  now?) with k8s-style semantics.

Snapshots aggregate the per-layer observability that already exists —
``Pipeline.element_stats()`` (queue drop/level counters, filter invoke
stats), ``serving`` scheduler metrics for the service's tensor_serving
elements, the pipeline LATENCY query — plus the supervisor's crash
reports, under one JSON-friendly dict.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils.log import logger


class HealthMonitor(threading.Thread):
    """Polls one service; cheap (reads two ints per tick)."""

    def __init__(self, service, poll_s: float = 0.05):
        super().__init__(name=f"svc:{service.name}:health", daemon=True)
        self.service = service
        self.poll_s = poll_s
        # NOT named _stop: threading.Thread has a private _stop() METHOD
        # that join() calls on a finished thread — shadowing it with an
        # Event makes every join() raise
        self._stop_evt = threading.Event()
        self._last_progress = -1
        self._last_progress_t = time.monotonic()

    def stop(self) -> None:
        self._stop_evt.set()

    def reset_watchdog(self) -> None:
        """Called at every (re)start so a restart isn't instantly re-flagged
        as a stall."""
        self._last_progress = -1
        self._last_progress_t = time.monotonic()

    def run(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - monitor must outlive hiccups
                logger.exception("service %s: health tick failed",
                                 self.service.name)

    def _tick(self) -> None:
        from .manager import ServiceState

        svc = self.service
        pipe = svc.pipeline
        if pipe is None:
            return
        state = svc.state
        # generation BEFORE progress: a restart bumps generation only
        # after play() reset the counter, so a (gen, progress) pair where
        # progress predates the restart carries the OLD generation and
        # _mark_ready rejects it — no false READY from stale counts
        generation = svc.generation
        progress = pipe.sink_buffer_count
        if state is ServiceState.STARTING and progress >= 1:
            svc._mark_ready(generation)
            return
        if state not in (ServiceState.STARTING, ServiceState.READY):
            return
        # -- stall watchdog --------------------------------------------------
        watchdog_s = svc.spec.watchdog_s
        if watchdog_s <= 0:
            return
        now = time.monotonic()
        if progress != self._last_progress:
            self._last_progress = progress
            self._last_progress_t = now
            return
        if now - self._last_progress_t < watchdog_s:
            return
        if svc._eos_seen or not any(s.running for s in pipe.sources):
            return  # stream legitimately over / being drained
        if svc.supervisor.has_pending_restart():
            return  # a crash restart is already scheduled — don't double-count
        self._last_progress_t = now  # re-arm; the restart resets it anyway
        msg = (f"stall: no sink progress in {watchdog_s:.1f}s "
               f"(stuck at {progress} buffers)")
        if state is ServiceState.READY:
            svc._mark_degraded(msg)
        else:
            # a STARTING service whose warmup never completes is the same
            # outage — hand it to the supervisor without the READY detour
            svc.supervisor.notify_crash("stall", "warmup stalled — " + msg)


# -- snapshot ----------------------------------------------------------------

def service_snapshot(service) -> dict:
    """One service's full health/observability snapshot (JSON-friendly)."""
    from .manager import ServiceState

    pipe = service.pipeline
    snap = {
        "name": service.name,
        "state": service.state.value,
        "live": service.liveness(),
        "ready": service.readiness(),
        "uptime_s": service.uptime_s(),
        "generation": service.generation,
        "launch": service.spec.launch,
        "supervisor": service.supervisor.snapshot(),
        "watchdog_s": service.spec.watchdog_s,
    }
    if pipe is None:
        return snap
    snap["sink_buffers"] = pipe.sink_buffer_count
    snap["elements"] = pipe.element_stats()
    # buffer loss rollup: the queue drop counters exist so the service
    # layer can SEE leaky-mode loss — surface the total at the top level
    dropped = 0
    for stats in snap["elements"].values():
        dropped += stats.get("dropped_upstream", 0)
        dropped += stats.get("dropped_downstream", 0)
    snap["queue_dropped_total"] = dropped
    serving = _serving_metrics(pipe)
    if serving:
        snap["serving"] = serving
    if service.state in (ServiceState.READY, ServiceState.DEGRADED):
        try:
            snap["latency"] = pipe.query_latency()
        except Exception:  # noqa: BLE001 - optional, needs negotiated pads
            pass
    models = service.model_bindings()
    if models:
        snap["models"] = models
    return snap


def _serving_metrics(pipe) -> dict:
    """Per-scheduler metrics for the pipeline's tensor_serving elements
    (the service-scoped view of ``serving.metrics_snapshot()``)."""
    out = {}
    for el in pipe.elements.values():
        sched = getattr(el, "scheduler", None)
        if sched is not None and hasattr(sched, "metrics_snapshot"):
            try:
                out[el.name] = sched.metrics_snapshot()
            except Exception:  # noqa: BLE001 - snapshot is best-effort
                pass
    return out
