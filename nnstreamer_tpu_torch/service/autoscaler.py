"""Closed-loop autoscaling: burn-rate sensors → replica-set actuators (L7).

The actuators are replica pools that route/retry/evict/readmit
(``fabric.py``, ``procreplica.py``); the sensors are SLO burn rates over
windowed latency digests and per-device memory watermarks
(``obs/{slo,profile,memory}.py``). This module is the controller between
them:

* **scale OUT before the page** — the multi-window SLO alert
  (:mod:`..obs.slo`) fires when the short AND long windows are hot; the
  autoscaler acts on the SHORT window alone crossing
  ``scale_out_burn``, so capacity arrives while the long window is
  still proving the regression is real. Growth is gated on memory
  headroom (a replica that would OOM the device is worse than shedding).
* **scale IN only when provably cool** — every window must be at or
  under ``scale_in_burn`` (hysteresis: ``scale_in_burn <
  scale_out_burn``), the scale-in cooldown must have expired, AND the
  projected post-shrink memory fraction (load redistributes onto the
  survivors) must stay under the watermark — the "scale-in blocked by
  memory" case counts ``nns_autoscaler_blocked_by_memory_total``.
* **per-direction cooldowns** — a scale event starts both cooldowns
  (growing then immediately shrinking is the flap this loop must never
  produce); oscillating load between the two thresholds holds steady.
* **graceful degradation at the ceiling** — when the loop WANTS to grow
  but cannot (``max_replicas`` reached, or memory headroom forbids), it
  arms the overload guard instead: the pool (and any serving queue
  handed to :meth:`Autoscaler.add_shed_queue`) refuses requests at or
  past ``shed_priority`` with a typed
  :class:`~..serving.request.OverloadShedError` — the lowest classes
  fail fast and the rest keep their p99, instead of everyone timing out
  together. The guard disarms when burn cools or capacity appears.
* **subprocess replica supervision** — against a
  :class:`~.procreplica.ProcReplicaSet` target the loop also reaps dead
  replica processes (SIGKILL chaos, OOM kills), respawns them under
  exponential backoff, and opens a per-replica respawn circuit breaker
  after ``max_respawns`` attempts inside ``respawn_window_s``: the
  hopeless identity is discarded CLEANLY and the surviving replicas
  keep serving.

* **fleet-merged sensing** — pass ``fleet=`` (an
  :class:`~..obs.fleet.FleetView`) and the burn windows are computed
  over the FLEET-merged digest of the series (exact bucket-wise merge
  across subprocess replicas, wall-clock aligned) instead of this
  process's local recorder: a replica restart that wipes its own
  windowed series cannot blind the controller, and serving-side series
  recorded inside the replicas become steerable.

Targets are duck-typed: anything with ``pool`` (a
:class:`~.fabric.ReplicaPool`), ``replica_count()``, ``scale_out()``
and ``scale_in()`` scales — :class:`~.fabric.ServiceFabric` (in-process
replicas) and :class:`~.procreplica.ProcReplicaSet` (subprocesses) both
do; the respawn loop additionally needs ``reap_dead()`` / ``respawn()``
/ ``discard()``.

Every decision is observable: ``autoscale``-category flight events
carry the full inputs (burn rates, samples, memory fraction, cooldown
state), ``nns_autoscaler_*`` gauges/counters ride ``GET /metrics``, and
``obs top`` renders an AUTOSCALER section. See docs/autoscaling.md for
the decision table and tuning notes.

Lock contract (docs/concurrency.md): ``Autoscaler._lock`` guards the
decision/respawn state and is a LEAF — never held across target
actuation (process spawns, drains), burn evaluation, or any network
call. The tick body runs on the single ``autoscaler:<name>`` thread (or
a test calling :meth:`Autoscaler.tick` directly — never both at once).
"""
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..analysis.sanitizer import named_lock
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..utils.log import logger


@dataclass
class AutoscalerConfig:
    """Tuning knobs (docs/autoscaling.md has the full decision table)."""

    min_replicas: int = 1
    max_replicas: int = 4
    # the SLO the loop defends: target fraction of requests under
    # latency_slo_s; burn = bad_fraction / (1 - target)
    latency_slo_s: float = 0.1
    target: float = 0.99
    short_window_s: float = 10.0
    long_window_s: float = 60.0
    scale_out_burn: float = 2.0     # short-window burn that adds a replica
    scale_in_burn: float = 0.5      # every window at/under this may shrink
    min_samples: int = 8            # don't scale on digest noise
    scale_out_cooldown_s: float = 10.0
    scale_in_cooldown_s: float = 30.0
    # memory headroom (obs/memory.py): growth needs used <= this; shrink
    # needs the PROJECTED post-shrink fraction (used × n/(n-1)) <= this
    memory_max_fraction: float = 0.85
    # overload guard: priority cutoff armed at the ceiling (lower value =
    # more important; requests with priority >= this shed typed)
    shed_priority: int = 1
    tick_s: float = 1.0
    # subprocess respawn schedule + circuit breaker
    respawn_backoff_base_s: float = 0.5
    respawn_backoff_factor: float = 2.0
    respawn_backoff_max_s: float = 8.0
    max_respawns: int = 5
    respawn_window_s: float = 60.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target={self.target} must be in (0, 1)")
        if self.scale_in_burn >= self.scale_out_burn:
            raise ValueError(
                f"hysteresis requires scale_in_burn ({self.scale_in_burn}) "
                f"< scale_out_burn ({self.scale_out_burn})")
        if self.short_window_s <= 0 or self.long_window_s < self.short_window_s:
            raise ValueError(
                f"need 0 < short_window_s <= long_window_s, got "
                f"{self.short_window_s}/{self.long_window_s}")
        if not 0.0 < self.memory_max_fraction <= 1.0:
            raise ValueError(
                f"memory_max_fraction={self.memory_max_fraction} must be "
                "in (0, 1]")


class _RespawnState:
    """Per-replica respawn schedule + breaker accounting."""

    __slots__ = ("attempts", "next_try_at", "attempt_times", "given_up")

    def __init__(self):
        self.attempts = 0            # consecutive failures (backoff input)
        self.next_try_at = 0.0
        self.attempt_times: List[float] = []   # breaker window
        self.given_up = False


class Autoscaler:
    """One control loop bound to one scaling target (see module doc)."""

    def __init__(self, target, config: Optional[AutoscalerConfig] = None,
                 *, name: Optional[str] = None,
                 series: Optional[str] = None,
                 profiler: Optional[obs_profile.Profiler] = None,
                 fleet=None,
                 memory_fraction_fn=None):
        self.target = target
        self.config = config or AutoscalerConfig()
        self.name = name or getattr(target, "name", "autoscaler")
        # the latency series burn is computed from — the fabric pool's
        # request digests by default (obs/profile.py windowed series).
        # With fleet= the default is the replicas' own serve series
        # instead: "fabric:<pool>" lives in the PARENT's recorder only
        # (no replica exports it), so the fleet read would silently
        # fall back to local while claiming source=fleet
        if series:
            self.series = series
        elif fleet is not None:
            self.series = "serving:query"   # query/server.SERVE_SERIES
        else:
            self.series = f"fabric:{target.pool.name}"
        # fleet= points the burn windows at a FleetView's MERGED series
        # (obs/fleet.py request_window — the same read signature as a
        # Profiler): scaling decisions then survive any single replica
        # whose local recorder restarted, and a serving-side series
        # recorded INSIDE the subprocess replicas becomes steerable
        if fleet is not None and profiler is not None:
            raise ValueError("pass fleet= or profiler=, not both")
        self.fleet = fleet
        if fleet is not None:
            self._profiler = fleet
        else:
            self._profiler = (profiler if profiler is not None
                              else obs_profile.default_profiler)
        # injectable for tests; default = worst per-device used/budget
        if memory_fraction_fn is None:
            from ..obs import memory as obs_memory

            memory_fraction_fn = obs_memory.used_fraction
        self._memory_fraction = memory_fraction_fn
        self._lock = named_lock(f"Autoscaler._lock:{self.name}")
        self._out_ok_at = 0.0               # guarded-by: _lock
        self._in_ok_at = 0.0                # guarded-by: _lock
        self._shed_armed = False            # guarded-by: _lock
        self._desired = self.target.replica_count()  # guarded-by: _lock
        self._respawn: Dict[str, _RespawnState] = {}  # guarded-by: _lock
        self._shed_queues: List = []        # guarded-by: _lock
        self.stats = {"scale_out": 0, "scale_in": 0,
                      "blocked_by_memory": 0, "shed_armed": 0,
                      "respawns": 0, "respawn_failures": 0,
                      "respawn_gave_up": 0}  # guarded-by: _lock
        self._last_decision: dict = {}      # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _autoscalers.add(self)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Autoscaler":
        t = self._thread
        if t is not None:
            if t.is_alive():
                return self
            # a timed-out stop() left the thread unforgotten and it has
            # since exited: finish that stop's bookkeeping before
            # starting fresh (exactly one end per begun calibration)
            self._thread = None
            obs_profile.end_calibration()
        # keep the profiler's request recording alive for the burn
        # windows — the refcounted calibration half, so neither a capture
        # session stopping nor the last SLO engine stopping silences the
        # series this loop steers by (obs/profile.py ACTIVE contract)
        obs_profile.begin_calibration()
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"autoscaler:{self.name}",
                                        daemon=True)
        self._thread.start()
        _autoscalers.add(self)
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is None:
            return
        # a tick can legitimately outlast this join (a subprocess
        # scale-out waits up to spawn_timeout_s for a READY line)
        t.join(timeout=max(10.0, self.config.tick_s * 3))
        if t.is_alive():
            # do NOT forget a live thread: a restart would spawn a
            # SECOND control loop (two concurrent actuators), and the
            # calibration refcount must stay held while it still reads
            # the burn series. The next start()/stop() finishes the
            # bookkeeping once the tick drains.
            logger.warning("autoscaler %s: tick thread still mid-action "
                           "after stop join; it will exit when the "
                           "action completes", self.name)
            return
        self._thread = None
        obs_profile.end_calibration()
        # leave the scrape/profile surfaces NOW, not when GC collects
        # the weak ref (same stance as obs_metrics.untrack_*)
        _autoscalers.discard(self)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.config.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the controller must outlive
                # one bad tick (a racing scale-in, a mid-stop target)
                logger.exception("autoscaler %s: tick failed", self.name)

    # -- shedding surface -----------------------------------------------------
    def add_shed_queue(self, queue) -> None:
        """Also arm/disarm a serving :class:`~..serving.queue.RequestQueue`
        (or any object with ``set_overload``/``clear_overload``) together
        with the pool — for in-process serving planes that sit behind
        this loop's capacity."""
        with self._lock:
            self._shed_queues.append(queue)
            armed = self._shed_armed
        if armed:
            queue.set_overload(self.config.shed_priority)

    def _arm_shed(self, reason: str, decision: dict) -> None:
        with self._lock:
            first = not self._shed_armed
            self._shed_armed = True
            if first:
                self.stats["shed_armed"] += 1
            queues = list(self._shed_queues)
        if not first:
            return
        self.target.pool.set_overload_shed(self.config.shed_priority)
        for q in queues:
            q.set_overload(self.config.shed_priority)
        _SHED_TRANSITIONS.inc(autoscaler=self.name)
        obs_flight.record("autoscale", "shed_armed",
                          {**decision, "reason": reason,
                           "min_priority": self.config.shed_priority})
        logger.warning("autoscaler %s: overload guard ARMED (%s) — "
                       "priority >= %d sheds typed", self.name, reason,
                       self.config.shed_priority)

    def _disarm_shed(self, reason: str, decision: dict) -> None:
        with self._lock:
            if not self._shed_armed:
                return
            self._shed_armed = False
            queues = list(self._shed_queues)
        self.target.pool.clear_overload_shed()
        for q in queues:
            q.clear_overload()
        obs_flight.record("autoscale", "shed_disarmed",
                          {**decision, "reason": reason})
        logger.info("autoscaler %s: overload guard disarmed (%s)",
                    self.name, reason)

    # -- the control loop -----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> dict:
        """One decide→act→observe pass; returns the decision record.
        Called by the tick thread — or directly by tests/CLIs with a
        controlled ``now`` (never both concurrently)."""
        cfg = self.config
        t = time.monotonic() if now is None else now
        self._respawn_tick(t)
        burn_short, n_short = self._burn(cfg.short_window_s, t)
        burn_long, n_long = self._burn(cfg.long_window_s, t)
        used = float(self._memory_fraction())
        current = self.target.replica_count()
        with self._lock:
            out_cooldown = max(0.0, self._out_ok_at - t)
            in_cooldown = max(0.0, self._in_ok_at - t)
            shed_armed = self._shed_armed
        hot = burn_short >= cfg.scale_out_burn and n_short >= cfg.min_samples
        cool = burn_short <= cfg.scale_in_burn and burn_long <= cfg.scale_in_burn
        wanted = current + (1 if hot else -1 if cool else 0)
        desired = max(cfg.min_replicas, min(cfg.max_replicas, wanted))
        decision = {
            "autoscaler": self.name, "series": self.series,
            "source": ("fleet:" + self.fleet.name
                       if self.fleet is not None else "local"),
            "replicas": current, "desired": desired,
            "burn_short": round(burn_short, 3),
            "burn_long": round(burn_long, 3),
            "samples_short": n_short, "samples_long": n_long,
            "memory_used_fraction": round(used, 4),
            "out_cooldown_s": round(out_cooldown, 2),
            "in_cooldown_s": round(in_cooldown, 2),
            "shed_armed": shed_armed,
        }
        action = "hold"
        if hot and out_cooldown <= 0.0:
            action = self._try_scale_out(current, used, t, decision)
        elif cool and current > cfg.min_replicas and in_cooldown <= 0.0:
            action = self._try_scale_in(current, used, t, decision)
        if shed_armed or self._shed_armed:
            # disarm on cool-down OR when capacity opened up below the
            # ceiling (a scale-out above already disarmed on its own)
            if burn_short <= cfg.scale_in_burn:
                self._disarm_shed(
                    f"burn cooled to {burn_short:.2f}", decision)
        with self._lock:
            self._desired = desired
            self._last_decision = {**decision, "action": action,
                                   "time": time.time()}
        return self._last_decision

    def _try_scale_out(self, current: int, used: float, t: float,
                       decision: dict) -> str:
        cfg = self.config
        if current >= cfg.max_replicas:
            self._arm_shed(f"at max_replicas={cfg.max_replicas} and "
                           f"burn {decision['burn_short']}", decision)
            return "blocked:ceiling"
        if used > cfg.memory_max_fraction:
            with self._lock:
                self.stats["blocked_by_memory"] += 1
            _BLOCKED_MEM.inc(autoscaler=self.name)
            obs_flight.record("autoscale", "scaleout_blocked",
                              {**decision, "reason": "memory"})
            self._arm_shed(
                f"memory {used:.2f} > {cfg.memory_max_fraction:.2f} "
                "forbids growth", decision)
            return "blocked:memory"
        rid = self.target.scale_out()
        with self._lock:
            self.stats["scale_out"] += 1
            # BOTH cooldowns restart: the new replica must prove itself
            # before the loop may grow again, and a fresh grow must
            # never be immediately unwound by a stale cool window
            self._out_ok_at = t + cfg.scale_out_cooldown_s
            self._in_ok_at = t + cfg.scale_in_cooldown_s
        _SCALE_EVENTS.inc(autoscaler=self.name, direction="out")
        obs_flight.record("autoscale", "scale_out",
                          {**decision, "replica": rid})
        logger.info("autoscaler %s: scale OUT -> %d (%s; burn %s)",
                    self.name, self.target.replica_count(), rid,
                    decision["burn_short"])
        self._disarm_shed("scaled out", decision)
        return "scale_out"

    def _try_scale_in(self, current: int, used: float, t: float,
                      decision: dict) -> str:
        cfg = self.config
        # survivors inherit the departed replica's share: projected
        # per-device fraction after shrinking must stay under watermark
        projected = used * current / max(1, current - 1)
        if projected > cfg.memory_max_fraction:
            with self._lock:
                self.stats["blocked_by_memory"] += 1
            _BLOCKED_MEM.inc(autoscaler=self.name)
            obs_flight.record("autoscale", "scalein_blocked",
                              {**decision, "reason": "memory",
                               "projected_fraction": round(projected, 4)})
            return "blocked:memory"
        rid = self.target.scale_in()
        with self._lock:
            self.stats["scale_in"] += 1
            self._in_ok_at = t + cfg.scale_in_cooldown_s
        _SCALE_EVENTS.inc(autoscaler=self.name, direction="in")
        obs_flight.record("autoscale", "scale_in",
                          {**decision, "replica": rid})
        logger.info("autoscaler %s: scale IN -> %d (removed %s)",
                    self.name, self.target.replica_count(), rid)
        return "scale_in"

    def _burn(self, window_s: float, now: float):
        digest, _ok, _err = self._profiler.request_window(
            self.series, window_s, now=now)
        total = digest.count
        if total == 0:
            return 0.0, 0
        bad = digest.count_above(self.config.latency_slo_s)
        budget = max(1e-9, 1.0 - self.config.target)
        return (bad / total) / budget, total

    # -- subprocess respawn supervision ---------------------------------------
    def _respawn_tick(self, t: float) -> None:
        reap = getattr(self.target, "reap_dead", None)
        if reap is None:
            return  # in-process target: the supervisor handles restarts
        cfg = self.config
        for rid in reap():
            with self._lock:
                state = self._respawn.setdefault(rid, _RespawnState())
                state.next_try_at = min(state.next_try_at, t)  # try now
        due: List[str] = []
        with self._lock:
            for rid, state in self._respawn.items():
                if not state.given_up and t >= state.next_try_at:
                    due.append(rid)
        for rid in due:
            self._attempt_respawn(rid, t)

    def _attempt_respawn(self, rid: str, t: float) -> None:
        cfg = self.config
        with self._lock:
            state = self._respawn[rid]
            state.attempt_times.append(t)
            state.attempt_times = [
                x for x in state.attempt_times
                if t - x <= cfg.respawn_window_s]
            if len(state.attempt_times) > cfg.max_respawns:
                # circuit breaker: this identity is hopeless — drop it
                # cleanly and keep the survivors serving
                state.given_up = True
                self.stats["respawn_gave_up"] += 1
        if state.given_up:
            obs_flight.record("autoscale", "respawn_gave_up",
                              {"autoscaler": self.name, "replica": rid,
                               "attempts": len(state.attempt_times),
                               "window_s": cfg.respawn_window_s})
            logger.error(
                "autoscaler %s: respawn circuit breaker OPEN for %s "
                "(%d attempts in %.0fs) — discarding the replica, pool "
                "keeps serving", self.name, rid,
                len(state.attempt_times), cfg.respawn_window_s)
            discard = getattr(self.target, "discard", None)
            if discard is not None:
                discard(rid)
            return
        ok = False
        try:
            ok = bool(self.target.respawn(rid))
        except Exception:  # noqa: BLE001 - a spawn blowup is a failed try
            logger.exception("autoscaler %s: respawn of %s raised",
                             self.name, rid)
        with self._lock:
            state = self._respawn.get(rid)
            if state is None:
                return
            if ok:
                self.stats["respawns"] += 1
                state.attempts = 0
                # parked until the NEXT observed death re-arms it (reap
                # lowers next_try_at); attempt_times stay: the breaker
                # window must see a crash-LOOP even when individual
                # respawns succeed
                state.next_try_at = float("inf")
            else:
                self.stats["respawn_failures"] += 1
                state.attempts += 1
                backoff = min(
                    cfg.respawn_backoff_base_s
                    * (cfg.respawn_backoff_factor ** (state.attempts - 1)),
                    cfg.respawn_backoff_max_s)
                state.next_try_at = t + backoff
        _RESPAWNS.inc(autoscaler=self.name,
                      outcome="ok" if ok else "failed")
        obs_flight.record(
            "autoscale", "respawn" if ok else "respawn_failed",
            {"autoscaler": self.name, "replica": rid,
             "attempt": len(state.attempt_times),
             "next_backoff_s": (0.0 if ok else
                                round(state.next_try_at - t, 2))})

    # -- reading --------------------------------------------------------------
    def shed_armed(self) -> bool:
        with self._lock:
            return self._shed_armed

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "series": self.series,
                "source": ("fleet:" + self.fleet.name
                           if self.fleet is not None else "local"),
                "replicas": self.target.replica_count(),
                "desired_replicas": self._desired,
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "shed_armed": self._shed_armed,
                "running": self._thread is not None,
                **self.stats,
                "respawn_slots": {
                    rid: {"attempts_in_window": len(s.attempt_times),
                          "given_up": s.given_up}
                    for rid, s in self._respawn.items()},
                "last_decision": dict(self._last_decision),
            }


# -- module registry + metrics ------------------------------------------------

_autoscalers: "weakref.WeakSet[Autoscaler]" = weakref.WeakSet()

_SCALE_EVENTS = obs_metrics.counter(
    "nns_autoscaler_scale_events_total",
    "replica-set scale actions taken", ("autoscaler", "direction"))
_BLOCKED_MEM = obs_metrics.counter(
    "nns_autoscaler_blocked_by_memory_total",
    "scale actions refused by the memory-headroom gate", ("autoscaler",))
_RESPAWNS = obs_metrics.counter(
    "nns_autoscaler_respawn_attempts_total",
    "subprocess replica respawn attempts", ("autoscaler", "outcome"))
_SHED_TRANSITIONS = obs_metrics.counter(
    "nns_autoscaler_shed_arm_total",
    "overload-guard arm transitions (at the ceiling)", ("autoscaler",))


def snapshot_all() -> List[dict]:
    """Snapshot across every live autoscaler (``GET /profile``'s
    ``autoscale`` block, ``obs top``'s AUTOSCALER section)."""
    return [a.snapshot() for a in list(_autoscalers)]


def _collect_autoscaler(reg: obs_metrics.Registry) -> None:
    replicas = reg.gauge("nns_autoscaler_replicas",
                         "current replica count", ("autoscaler",))
    desired = reg.gauge("nns_autoscaler_desired_replicas",
                        "controller's bounded desired replica count",
                        ("autoscaler",))
    armed = reg.gauge("nns_autoscaler_shed_armed",
                      "1 while the overload guard is armed",
                      ("autoscaler",))
    for inst in (replicas, desired, armed):
        inst.clear()
    for a in list(_autoscalers):
        try:
            snap = a.snapshot()
        except Exception:  # noqa: BLE001 - target mid-teardown
            continue
        replicas.set(snap["replicas"], autoscaler=snap["name"])
        desired.set(snap["desired_replicas"], autoscaler=snap["name"])
        armed.set(1.0 if snap["shed_armed"] else 0.0,
                  autoscaler=snap["name"])


obs_metrics.register_collector("autoscaler", _collect_autoscaler)
