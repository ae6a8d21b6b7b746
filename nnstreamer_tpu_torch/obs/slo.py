"""Declarative SLOs with multi-window burn-rate alerting (L7).

The port of nnstreamer_tpu's ``obs/slo.py``: "is the error budget
burning faster than the objective allows, on both a fast and a slow
window, right now?", evaluated from the profiler's windowed request
digests (:mod:`.profile` — ``WindowedSeries``; digest merge is exact, so
a window IS the digest of its samples).

Objective kinds:

* ``latency`` — good event = request latency <= ``threshold_s``
  (``target`` = required good fraction, e.g. 0.99 ⇒ "p99 under
  threshold"); bad counts come from ``QuantileDigest.count_above``.
* ``error_rate`` — good event = request succeeded.
* ``availability`` — the engine itself samples the bound service's
  readiness each tick into an ``availability:<service>`` series.
* ``memory`` — the engine samples the worst device's used fraction
  (:func:`.memory.used_fraction`) each tick.
* ``quality`` — the engine samples the worst per-edge drift score
  (:func:`.quality.worst_score`) each tick.

**Burn rate** = (bad fraction in window) / (1 - target). Burn 1.0 means
the budget exactly runs out over the objective period; an alert fires
when burn >= the pair's threshold on BOTH the short and the long window
(the standard multi-window construction: the long window proves it is
real, the short window proves it is still happening), and clears when
every short-window burn falls back under its threshold.

On breach: a ``slo`` flight-recorder event, ``nns_slo_*`` gauges, and —
when the objective names a ``service`` and the engine was given a
``manager`` (anything with ``get(name)`` returning an object with
``readiness()``, ``mark_degraded_external(reason)`` and
``mark_recovered(reason)``; the reference's ``ServiceManager``, which
the port does not have yet, ROADMAP A6) — the service flips DEGRADED,
and back on recovery. ``availability`` objectives never degrade (the
service is already down — alerting only).
"""
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ..analysis.sanitizer import named_lock
from ..utils.log import logger
from . import flight as obs_flight
from . import metrics as obs_metrics
from . import profile as obs_profile

_KINDS = ("latency", "error_rate", "availability", "memory", "quality")

# default multi-window pairs (short_s, long_s, burn_threshold), sized to
# fit the profiler's default 900 s series horizon; production configs
# with longer horizons pass the classic (5m,1h,14.4)/(30m,6h,6) pairs
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (60.0, 300.0, 14.4),
    (300.0, 900.0, 6.0),
)


@dataclass
class SLObjective:
    """One declarative objective over a request series."""

    name: str
    kind: str = "latency"     # latency | error_rate | availability |
    #                           memory | quality
    series: str = ""                 # e.g. "serving:svc" / "fabric:pool"
    target: float = 0.99             # required good fraction
    threshold_s: float = 0.1         # latency: good = sample <= this;
    #                                  memory: max used-fraction (headroom
    #                                  = 1 - threshold; the engine samples
    #                                  worst-device used/budget each tick);
    #                                  quality: max drift score (the engine
    #                                  samples the worst per-edge PSI drift
    #                                  each tick — obs/quality.worst_score)
    windows: Tuple[Tuple[float, float, float], ...] = DEFAULT_WINDOWS
    service: str = ""                # Service to flip DEGRADED on breach
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind '{self.kind}' must be one of {_KINDS}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target={self.target} must be in (0, 1)")
        if self.kind == "availability":
            if not self.service:
                raise ValueError("availability objectives require service=")
            if not self.series:
                self.series = f"availability:{self.service}"
        elif self.kind == "memory":
            if not 0.0 < self.threshold_s <= 1.0:
                raise ValueError(
                    f"memory objectives need threshold_s in (0, 1] "
                    f"(max used fraction), got {self.threshold_s}")
            if not self.series:
                self.series = "memory:devices"
        elif self.kind == "quality":
            if self.threshold_s <= 0.0:
                raise ValueError(
                    f"quality objectives need threshold_s > 0 (max drift "
                    f"score), got {self.threshold_s}")
            if not self.series:
                self.series = "quality:stages"
        elif not self.series:
            raise ValueError(f"objective '{self.name}' needs a series=")
        if not self.windows:
            raise ValueError("at least one (short, long, burn) window pair")
        for w in self.windows:
            if len(w) != 3 or w[0] <= 0 or w[1] < w[0] or w[2] <= 0:
                raise ValueError(
                    f"bad window spec {w}: need (short_s, long_s, "
                    "burn_threshold) with 0 < short <= long, burn > 0")

    def spec(self) -> dict:
        return {"name": self.name, "kind": self.kind, "series": self.series,
                "target": self.target, "threshold_s": self.threshold_s,
                "windows": [list(w) for w in self.windows],
                "service": self.service,
                "description": self.description}


class SloEngine:
    """Evaluates a set of objectives on a tick thread (or on demand via
    :meth:`evaluate` — tests and one-shot CLIs). Starting the engine
    switches the profiler's request recording on
    (:func:`~.profile.enable_recording`)."""

    def __init__(self, manager=None, profiler: Optional[obs_profile.Profiler]
                 = None, tick_s: float = 1.0, name: str = "default"):
        self.name = name
        self.manager = manager
        self.tick_s = tick_s
        self._profiler = (profiler if profiler is not None
                          else obs_profile.default_profiler)
        self._lock = named_lock(f"SloEngine._lock:{name}")
        self._objectives: Dict[str, SLObjective] = {}  # guarded-by: _lock
        self._state: Dict[str, dict] = {}              # guarded-by: _lock
        # services THIS engine flipped DEGRADED, with the set of
        # objectives currently holding them there: two objectives on one
        # service must both recover before the service flips back
        self._degraded: Dict[str, Set[str]] = {}       # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _engines.add(self)

    # -- configuration -------------------------------------------------------
    def add(self, objective: SLObjective) -> "SloEngine":
        with self._lock:
            self._objectives[objective.name] = objective
        return self

    def remove(self, name: str) -> None:
        with self._lock:
            self._objectives.pop(name, None)
            self._state.pop(name, None)

    def objectives(self) -> List[SLObjective]:
        with self._lock:
            return list(self._objectives.values())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SloEngine":
        if self._thread is not None:
            return self
        obs_profile.enable_recording()
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"slo:{self.name}",
                                        daemon=True)
        self._thread.start()
        _engines.add(self)  # re-register after a stop()'s discard
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        # the last running engine switches the recording half off (a
        # profile.start() capture session has its own flag and is
        # unaffected either way)
        if not any(e._thread is not None for e in _engines if e is not self):
            obs_profile.disable_recording()
        # leave the status/gauge scrape surface NOW, not when GC collects
        # the weak ref (the PR-10 unregister-at-stop stance; start()
        # re-adds on restart)
        _engines.discard(self)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.tick_s):
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001 - the evaluator must outlive
                # a bad tick (a mid-shutdown manager, a racing deregister)
                logger.exception("slo engine %s: evaluation tick failed",
                                 self.name)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass over every objective; returns the new
        status list. Called by the tick thread and directly by tests."""
        t = time.monotonic() if now is None else now
        with self._lock:
            objectives = list(self._objectives.values())
        statuses = []
        for obj in objectives:
            statuses.append(self._evaluate_one(obj, t))
        return statuses

    def _evaluate_one(self, obj: SLObjective, now: float) -> dict:
        if obj.kind == "availability":
            self._sample_availability(obj, now)
        elif obj.kind == "memory":
            self._sample_memory(obj, now)
        elif obj.kind == "quality":
            self._sample_quality(obj, now)
        budget = max(1e-9, 1.0 - obj.target)
        windows = []
        any_pair_breach = False
        all_short_cool = True
        for short_s, long_s, burn_thr in obj.windows:
            b_short, f_short, n_short = self._burn(obj, short_s, budget, now)
            b_long, f_long, n_long = self._burn(obj, long_s, budget, now)
            pair_breach = b_short >= burn_thr and b_long >= burn_thr
            any_pair_breach = any_pair_breach or pair_breach
            all_short_cool = all_short_cool and b_short < burn_thr
            windows.append({
                "short_s": short_s, "long_s": long_s,
                "burn_threshold": burn_thr,
                "burn_short": b_short, "burn_long": b_long,
                "bad_fraction_short": f_short, "bad_fraction_long": f_long,
                "samples_short": n_short, "samples_long": n_long,
                "breaching": pair_breach,
            })
        with self._lock:
            prev = self._state.get(obj.name, {})
            was_alerting = bool(prev.get("alerting"))
            if not was_alerting and any_pair_breach:
                alerting, transition = True, "breach"
            elif was_alerting and all_short_cool:
                # recovery hysteresis: every fast window must cool down
                alerting, transition = False, "recover"
            else:
                alerting, transition = was_alerting, None
            status = {**obj.spec(), "alerting": alerting,
                      "windows": windows,
                      "since": (time.time() if transition
                                else prev.get("since"))}
            self._state[obj.name] = status
        if transition == "breach":
            self._on_breach(obj, windows)
        elif transition == "recover":
            self._on_recover(obj)
        elif alerting:
            self._ensure_degraded(obj, windows)
        return status

    def _burn(self, obj: SLObjective, window_s: float, budget: float,
              now: float) -> Tuple[float, float, int]:
        """(burn rate, bad fraction, sample count) over one window."""
        digest, ok, err = self._profiler.request_window(
            obj.series, window_s, now=now)
        if obj.kind in ("latency", "memory", "quality"):
            # memory samples are used-fractions and quality samples are
            # drift scores: "bad" = a tick whose worst device/edge
            # crossed the threshold — same count_above machinery as
            # latency over seconds
            total = digest.count
            bad = digest.count_above(obj.threshold_s)
        else:
            total = ok + err
            bad = err
        if total == 0:
            return 0.0, 0.0, 0
        frac = bad / total
        return frac / budget, frac, total

    def _sample_availability(self, obj: SLObjective, now: float) -> None:
        svc = self._service(obj.service)
        if svc is None:
            return
        self._profiler.record_request(obj.series, 0.0,
                                      ok=svc.readiness(), now=now)

    def _sample_memory(self, obj: SLObjective, now: float) -> None:
        """Memory-pressure objectives sample themselves each tick, like
        availability: the worst per-device used/budget fraction
        (obs/memory.py — 0.0 when no budget is configured) lands in the
        objective's series; the burn math reads headroom crossings."""
        from . import memory as obs_memory

        self._profiler.record_request(obj.series,
                                      obs_memory.used_fraction(),
                                      ok=True, now=now)

    def _sample_quality(self, obj: SLObjective, now: float) -> None:
        """Quality objectives sample themselves each tick, like memory:
        the worst per-edge drift score (obs/quality.py — fresh NaN/Inf
        score NONFINITE_SCORE, drifted distributions their PSI vs the
        baseline, clean or idle edges 0.0) lands in the objective's
        series; the burn math reads threshold crossings, and recovery
        follows automatically once fresh samples come back clean."""
        from . import quality as obs_quality

        self._profiler.record_request(
            obj.series,
            # per-objective consumer key: each objective owns its own
            # fresh-sample window, so two quality objectives on one
            # engine (or across engines) never starve each other
            obs_quality.worst_score(consumer=f"slo:{self.name}:{obj.name}"),
            ok=True, now=now)

    # -- actions -------------------------------------------------------------
    def _service(self, name: str):
        if self.manager is None or not name:
            return None
        try:
            return self.manager.get(name)
        except Exception:  # noqa: BLE001 - deregistered mid-flight
            return None

    def _on_breach(self, obj: SLObjective, windows: List[dict]) -> None:
        hot = next((w for w in windows if w["breaching"]), windows[0])
        detail = {
            "slo": obj.name, "kind": obj.kind, "series": obj.series,
            "target": obj.target,
            "burn_short": round(hot["burn_short"], 3),
            "burn_long": round(hot["burn_long"], 3),
            "window_s": [hot["short_s"], hot["long_s"]],
            "service": obj.service,
        }
        obs_flight.record("slo", "breach", detail)
        logger.warning(
            "SLO %s BREACH: burn %.1fx/%.1fx over %gs/%gs windows "
            "(target %.4f, series %s)", obj.name, hot["burn_short"],
            hot["burn_long"], hot["short_s"], hot["long_s"], obj.target,
            obj.series)
        self._ensure_degraded(obj, windows)

    def _ensure_degraded(self, obj: SLObjective, windows: List[dict]) -> None:
        # availability breaches never degrade: the service is already
        # down, and degrading it would feed the very signal we sample
        if obj.kind == "availability" or not obj.service:
            return
        with self._lock:
            holders = self._degraded.get(obj.service)
            if holders is not None:
                # the service is already held DOWN by this engine — just
                # register this objective as one more holder, so another
                # objective's recovery cannot flip it back prematurely
                holders.add(obj.name)
                return
        svc = self._service(obj.service)
        if svc is None:
            return
        hot = next((w for w in windows if w["breaching"]), windows[0])
        reason = (f"slo '{obj.name}' burn {hot['burn_short']:.1f}x over "
                  f"{hot['short_s']:g}s (target {obj.target:.4f})")
        if svc.mark_degraded_external(reason):
            with self._lock:
                self._degraded.setdefault(obj.service, set()).add(obj.name)

    def _on_recover(self, obj: SLObjective) -> None:
        obs_flight.record("slo", "recover",
                          {"slo": obj.name, "series": obj.series,
                           "service": obj.service})
        logger.info("SLO %s recovered (series %s)", obj.name, obj.series)
        if not obj.service:
            return
        with self._lock:
            holders = self._degraded.get(obj.service)
            if holders is None:
                return
            holders.discard(obj.name)
            if holders:
                return  # another objective still holds the service down
            del self._degraded[obj.service]
        svc = self._service(obj.service)
        if svc is not None:
            svc.mark_recovered(f"slo '{obj.name}' burn back under "
                               "threshold")

    # -- reading -------------------------------------------------------------
    def status(self) -> List[dict]:
        """The last evaluated status per objective (JSON-friendly; does
        NOT re-evaluate — scrape freshness is the tick cadence)."""
        with self._lock:
            return [dict(self._state.get(o.name, {**o.spec(),
                                                  "alerting": False,
                                                  "windows": []}))
                    for o in self._objectives.values()]


# -- module registry + metrics collector -------------------------------------

_engines: "weakref.WeakSet[SloEngine]" = weakref.WeakSet()


def status_all() -> List[dict]:
    """Status across every live engine (the ``slo`` half of
    ``GET /profile`` and the CLI's ``obs slo`` verb)."""
    out: List[dict] = []
    for engine in list(_engines):
        out.extend(engine.status())
    return out


def _collect_slo(reg: obs_metrics.Registry) -> None:
    burn = reg.gauge("nns_slo_burn_rate",
                     "error-budget burn rate per evaluation window",
                     ("slo", "window"))
    bad = reg.gauge("nns_slo_bad_fraction",
                    "bad-event fraction per evaluation window",
                    ("slo", "window"))
    alerting = reg.gauge("nns_slo_alerting",
                         "1 while the objective's burn alert is firing",
                         ("slo",))
    target = reg.gauge("nns_slo_target", "good-fraction objective",
                       ("slo",))
    # snapshot mirrors: a removed objective's series disappears
    for inst in (burn, bad, alerting, target):
        inst.clear()
    for st in status_all():
        if not st.get("name"):
            continue
        alerting.set(1.0 if st.get("alerting") else 0.0, slo=st["name"])
        target.set(st.get("target", 0.0), slo=st["name"])
        for w in st.get("windows", []):
            burn.set(w["burn_short"], slo=st["name"],
                     window=f"{w['short_s']:g}s")
            burn.set(w["burn_long"], slo=st["name"],
                     window=f"{w['long_s']:g}s")
            bad.set(w["bad_fraction_short"], slo=st["name"],
                    window=f"{w['short_s']:g}s")
            bad.set(w["bad_fraction_long"], slo=st["name"],
                    window=f"{w['long_s']:g}s")


obs_metrics.register_collector("slo", _collect_slo)
