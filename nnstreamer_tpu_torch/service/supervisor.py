"""Service supervision: restart policies, backoff, circuit breaker (L7).

Reference analog: the ML-Service layer's managed-pipeline lifetime
(SURVEY §1 L6 — pipelines registered by name and kept alive independently
of any caller). The reference delegates keep-alive to the Tizen service
framework; here supervision is explicit and testable: a per-service
:class:`RestartPolicy` decides WHETHER a crashed service restarts, an
exponential-backoff schedule with deterministic jitter decides WHEN, and
a max-restarts circuit breaker decides when to stop trying. Every crash
is captured for postmortem (exception text + the last negotiated buffer
specs + element counters at the moment of death).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..analysis.sanitizer import named_lock
from ..obs import flight as obs_flight
from ..utils.log import logger


@dataclass
class RestartPolicy:
    """When and how a supervised service restarts after a crash.

    ``mode``:
      * ``never``      — first crash is final (state → FAILED);
      * ``on-failure`` — restart after crashes/stalls, not after clean EOS;
      * ``always``     — restart after crashes AND clean EOS (forever-services).
    """

    mode: str = "on-failure"
    backoff_base_s: float = 0.1     # first restart delay
    backoff_factor: float = 2.0     # exponential growth per consecutive crash
    backoff_max_s: float = 10.0     # delay ceiling
    jitter: float = 0.1             # ± fraction of the delay, seeded rng
    max_restarts: int = 5           # circuit breaker: crashes within window
    window_s: float = 60.0          # breaker accounting window

    def __post_init__(self):
        if self.mode not in ("never", "on-failure", "always"):
            raise ValueError(
                f"restart mode '{self.mode}' must be never|on-failure|always")

    @classmethod
    def from_config(cls, value) -> "RestartPolicy":
        """The config/HTTP spelling: a bare mode string or a field dict
        (shared by the serve CLI and the register endpoint)."""
        if isinstance(value, RestartPolicy):
            return value
        if isinstance(value, str):
            return cls(mode=value)
        return cls(**value)

    def delay_s(self, attempt: int, rng: Optional[random.Random] = None
                ) -> float:
        """Backoff before restart ``attempt`` (0-based): exponential,
        capped, with symmetric jitter so N crashed services don't restart
        in lockstep."""
        d = min(self.backoff_base_s * (self.backoff_factor ** attempt),
                self.backoff_max_s)
        if self.jitter > 0 and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


@dataclass
class CrashReport:
    """Postmortem capture of one service crash."""

    time: float                     # time.time() of the crash
    reason: str                     # "error" | "stall" | "eos"
    error: str                      # exception text / stall description
    source: str                     # element that died (or pipeline name)
    restart_index: int              # how many restarts preceded this crash
    buffer_specs: dict = field(default_factory=dict)   # last caps per pad
    element_stats: dict = field(default_factory=dict)  # counters at death
    # flight-recorder tail at capture time (obs/flight.py): the last
    # control-plane events — state flips, evictions, batch failures,
    # spans — leading UP to the crash, recorded before anyone knew to look
    flight: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "time": self.time,
            "reason": self.reason,
            "error": self.error,
            "source": self.source,
            "restart_index": self.restart_index,
            "buffer_specs": self.buffer_specs,
            "element_stats": self.element_stats,
            "flight": self.flight,
        }


def capture_buffer_specs(pipeline) -> dict:
    """Last negotiated caps per linked pad — the 'what was flowing when it
    died' half of a crash report."""
    specs = {}
    try:
        for el in pipeline.elements.values():
            for pad in el.sink_pads + el.src_pads:
                if pad.caps is not None:
                    specs[pad.full_name] = str(pad.caps)
    except Exception:  # noqa: BLE001 - postmortem capture is best-effort
        pass
    return specs


class Supervisor:
    """Owns one service's crash → backoff → restart loop.

    The service calls :meth:`notify_crash` (pipeline ERROR or watchdog
    stall) and :meth:`notify_eos` (clean stream end); the supervisor
    decides the outcome and drives ``service._supervised_restart()`` /
    ``service._supervised_give_up()`` on its own timer thread.
    """

    MAX_REPORTS = 16  # keep the most recent postmortems

    def __init__(self, service, policy: RestartPolicy,
                 jitter_seed: Optional[int] = None):
        self.service = service
        self.policy = policy
        self._lock = named_lock("Supervisor._lock")
        self.restarts = 0               # guarded-by: _lock
        self.breaker_open = False       # guarded-by: _lock
        self.crash_reports: List[CrashReport] = []
        self._crash_times: List[float] = []   # guarded-by: _lock
        self._consecutive = 0           # guarded-by: _lock
        self._gave_up = False           # guarded-by: _lock
        self._rng = random.Random(jitter_seed)
        self._timer: Optional[threading.Timer] = None  # guarded-by: _lock
        # _timer is nulled the moment it FIRES (so a new crash can
        # schedule); this list keeps every fired-but-still-running timer
        # joinable until join_threads — a restart mid stop/replay must
        # not outlive Service.shutdown() unobserved, even when a second
        # crash has scheduled the NEXT timer meanwhile
        self._restart_threads: List[threading.Timer] = []  # guarded-by: _lock
        self._giveup_thread: Optional[threading.Thread] = None

    # -- service feedback ----------------------------------------------------
    def note_healthy(self) -> None:
        """Service reached READY and is making progress: consecutive-crash
        backoff resets (the breaker window does not — a crash-loop that
        limps to READY between crashes still trips it)."""
        with self._lock:
            self._consecutive = 0

    def reset(self) -> None:
        """Operator-initiated (re)start: a fresh supervision epoch — the
        breaker window and backoff forget previous runs, so the policy's
        full restart budget applies again."""
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self.breaker_open = False
            self._gave_up = False
            self._consecutive = 0
            self._crash_times.clear()

    # -- crash path ----------------------------------------------------------
    def notify_crash(self, reason: str, error: str, source: str = "") -> None:
        """A supervised run died (pipeline ERROR or watchdog stall)."""
        with self._lock:
            # ONE crash per run: an element erroring on every buffer (or
            # several elements rejecting one poisoned buffer) delivers a
            # burst of error events before the sources halt — while a
            # restart is pending or the verdict is final, echoes of the
            # same dying run must not count against the breaker
            if self._timer is not None or self._gave_up:
                return
        report = self._capture(reason, error, source)
        with self._lock:
            if self._timer is not None or self._gave_up:
                return  # raced with another notifier during capture
            self.crash_reports.append(report)
            del self.crash_reports[:-self.MAX_REPORTS]
            now = time.monotonic()
            self._crash_times.append(now)
            self._crash_times = [t for t in self._crash_times
                                 if now - t <= self.policy.window_s]
            if self.policy.mode == "never":
                logger.warning("service %s: crashed (%s) — restart policy "
                               "is 'never'", self.service.name, reason)
                self._give_up_locked("restart policy 'never'")
                return
            if len(self._crash_times) > self.policy.max_restarts:
                logger.error(
                    "service %s: circuit breaker OPEN — %d crashes within "
                    "%.0fs (max %d)", self.service.name,
                    len(self._crash_times), self.policy.window_s,
                    self.policy.max_restarts)
                self.breaker_open = True
                self._give_up_locked("circuit breaker open")
                return
            attempt = self._consecutive
            self._consecutive += 1
            delay = self.policy.delay_s(attempt, self._rng)
            logger.warning(
                "service %s: crash #%d (%s: %s) — restart in %.3fs",
                self.service.name, len(self._crash_times), reason,
                error[:200], delay)
            self._schedule_restart_locked(delay)

    def notify_eos(self) -> None:
        """Stream ended cleanly. ``always`` services restart (they exist to
        run forever); everything else parks as completed."""
        with self._lock:
            if self._timer is not None:
                # a crash on one of the stream's final buffers already
                # scheduled a replay — the EOS that trickled out behind it
                # must not park the service as 'completed' and orphan the
                # restart
                return
        if self.policy.mode != "always":
            self.service._supervised_complete()
            return
        with self._lock:
            if self._gave_up:
                return
            self._consecutive = 0
            self._schedule_restart_locked(self.policy.backoff_base_s)

    # -- internals -----------------------------------------------------------
    def _capture(self, reason: str, error: str, source: str) -> CrashReport:
        obs_flight.record("service", "crash",
                          {"service": self.service.name, "reason": reason,
                           "error": error[:200]})
        pipe = self.service.pipeline
        return CrashReport(
            time=time.time(), reason=reason, error=error,
            source=source or self.service.name,
            restart_index=self.restarts,
            buffer_specs=capture_buffer_specs(pipe) if pipe else {},
            element_stats=pipe.element_stats() if pipe else {},
            flight=obs_flight.dump(last=64),
        )

    def _give_up_locked(self, why: str) -> None:
        self._gave_up = True
        # delivered on its own thread: _supervised_give_up takes the
        # SERVICE lock, and notifiers reach here holding ours — calling
        # through directly would nest Supervisor._lock -> Service._lock,
        # the reverse of the stop() path. Tracked + joined in
        # join_threads() (Service.shutdown), not fire-and-forget.
        self._giveup_thread = threading.Thread(
            target=self.service._supervised_give_up, args=(why,),
            name=f"svc:{self.service.name}:give-up", daemon=True)
        self._giveup_thread.start()

    def _schedule_restart_locked(self, delay: float) -> None:
        if self._timer is not None:
            return  # a restart is already pending
        self._timer = threading.Timer(delay, self._do_restart)
        self._timer.daemon = True
        # survives the fire (see __init__); pruned as timers finish
        self._restart_threads = [t for t in self._restart_threads
                                 if t.is_alive()] + [self._timer]
        self._timer.start()

    def _do_restart(self) -> None:
        with self._lock:
            self._timer = None
            self.restarts += 1
        try:
            self.service._supervised_restart()
        except Exception:  # noqa: BLE001 - restart failure logs, not raises
            logger.exception("service %s: supervised restart failed",
                             self.service.name)

    def has_pending_restart(self) -> bool:
        with self._lock:
            return self._timer is not None

    def cancel(self) -> None:
        """Abort any pending restart (service stopped/drained by the user).
        Cancel only — no join: callers hold the SERVICE lock, and the
        timer body re-takes it (join_threads does the joining, lock-free).
        """
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def join_threads(self, timeout_s: float = 2.0) -> None:
        """Join the supervision threads (pending timer, give-up delivery).
        MUST be called with no service/supervisor lock held: both threads
        take Service._lock on their way out."""
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            restarts, self._restart_threads = self._restart_threads, []
            giveup = self._giveup_thread
            self._giveup_thread = None
        # covers still-pending timers (canceled above) AND ones that
        # already FIRED and are mid _do_restart
        for t in restarts:
            if t is not threading.current_thread():
                t.join(timeout=timeout_s)
        if giveup is not None and giveup is not threading.current_thread():
            giveup.join(timeout=timeout_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy.mode,
                "restarts": self.restarts,
                "breaker_open": self.breaker_open,
                "crashes_in_window": len(self._crash_times),
                "max_restarts": self.policy.max_restarts,
                "crash_reports": [r.to_dict() for r in
                                  self.crash_reports[-4:]],
            }
