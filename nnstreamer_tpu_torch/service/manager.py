"""Named, supervised pipeline services: the control plane core (L7).

Reference analog: the ML-Service C API (the sibling-repo layer SURVEY §1
L6 rows point at) — pipelines registered by NAME, launched as managed
services, kept alive independently of any caller. Here that layer sits on
the in-process runtime: a :class:`ServiceManager` owns a table of
:class:`Service` objects, each wrapping one Pipeline with

* admission control — launch lines are statically linted
  (``analysis.lint_launch``) at registration; error findings reject;
* a supervised lifecycle —

      REGISTERED → STARTING → READY ⇄ DEGRADED
                        ↑         ↘ DRAINING → STOPPED
                        └── supervisor restart  ↘ FAILED

  readiness = caps negotiated AND one warmup inference completed
  end-to-end (first buffer rendered at a sink);
* crash supervision (:mod:`.supervisor`) and health probes + stall
  watchdog (:mod:`.health`);
* hot model rollout through versioned slots (:mod:`.models`).

The HTTP/CLI surface lives in :mod:`.api`; this module is the
programmatic API.
"""
from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..analysis.sanitizer import named_lock, named_rlock
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..utils.log import logger
from .health import HealthMonitor, service_snapshot
from .models import ModelSlots
from .supervisor import RestartPolicy, Supervisor


class ServiceError(RuntimeError):
    pass


class AdmissionRejected(ServiceError):
    """Registration refused: the static lint found error-severity
    findings (the diagnostics ride on the exception)."""

    def __init__(self, name: str, diagnostics):
        self.diagnostics = list(diagnostics)
        lines = "; ".join(d.format() for d in self.diagnostics)
        super().__init__(f"service '{name}' rejected by admission lint: "
                         f"{lines}")


class ServiceState(enum.Enum):
    REGISTERED = "registered"
    STARTING = "starting"
    READY = "ready"
    DEGRADED = "degraded"
    DRAINING = "draining"
    STOPPED = "stopped"
    FAILED = "failed"      # policy 'never' fired or circuit breaker open


# states in which a pipeline is (supposed to be) running
_ACTIVE = (ServiceState.STARTING, ServiceState.READY, ServiceState.DEGRADED)


@dataclass
class ServiceSpec:
    """Everything needed to (re)launch one service."""

    name: str
    launch: str
    restart: RestartPolicy = field(default_factory=RestartPolicy)
    watchdog_s: float = 0.0          # 0 = stall watchdog off
    warmup: str = "first-buffer"     # first-buffer | none
    warmup_timeout_s: float = 30.0   # start() blocks at most this long
    description: str = ""

    def __post_init__(self):
        if self.warmup not in ("first-buffer", "none"):
            raise ValueError(
                f"warmup '{self.warmup}' must be first-buffer|none")


class Service:
    """One named, supervised pipeline service."""

    def __init__(self, manager: "ServiceManager", spec: ServiceSpec,
                 jitter_seed: Optional[int] = None):
        self.manager = manager
        self.spec = spec
        # RLock: state transitions re-enter through _set_state. The lock
        # ORDER contract is Service._lock -> Supervisor._lock (stop/drain
        # cancel the supervisor while holding ours); the supervisor never
        # calls back into the service with its own lock held — see
        # docs/concurrency.md.
        self._lock = named_rlock("Service._lock")
        self.state = ServiceState.REGISTERED      # guarded-by: _lock
        self.state_reason = "registered"          # guarded-by: _lock
        self.pipeline = None                      # guarded-by: _lock
        self.supervisor = Supervisor(self, spec.restart, jitter_seed)
        self.generation = 0           # play() count   guarded-by: _lock
        self.registered_at = time.time()
        self.started_at: Optional[float] = None   # guarded-by: _lock
        self._monitor: Optional[HealthMonitor] = None  # guarded-by: _lock
        self._query_server = None                 # guarded-by: _lock
        self._eos_seen = False                    # guarded-by: _lock
        # True between a supervised restart's STARTING flip and its
        # generation bump: the restart stops/replays the pipeline OUTSIDE
        # the lock, and the monitor must not promote READY from a
        # progress count read in that window (it may be the old run's)
        self._restarting = False                  # guarded-by: _lock
        self._ready_evt = threading.Event()
        self._drained_evt = threading.Event()
        self._history: List[tuple] = [(time.time(), "registered", "")]  # guarded-by: _lock

    @property
    def name(self) -> str:
        return self.spec.name

    # -- state bookkeeping ---------------------------------------------------
    def _set_state(self, new: ServiceState, reason: str = "") -> None:
        with self._lock:
            if self.state is new:
                return
            logger.info("service %s: %s -> %s%s", self.name,
                        self.state.value, new.value,
                        f" ({reason})" if reason else "")
            self.state = new
            self.state_reason = reason
            self._history.append((time.time(), new.value, reason))
            del self._history[:-32]
            obs_flight.record("service", new.value,
                              {"service": self.name,
                               "reason": reason[:200]})
            if new is ServiceState.READY:
                self._ready_evt.set()
            else:
                self._ready_evt.clear()

    def history(self) -> List[tuple]:
        with self._lock:
            return list(self._history)

    # -- probes --------------------------------------------------------------
    def liveness(self) -> bool:
        """Is the service where its state says it should be? (playing when
        active, parked when stopped)."""
        with self._lock:
            if self.state in _ACTIVE:
                return self.pipeline is not None and self.pipeline.playing
            return self.state is not ServiceState.FAILED

    def readiness(self) -> bool:
        return self.state is ServiceState.READY

    def uptime_s(self) -> float:
        with self._lock:
            if self.started_at is None or self.state not in _ACTIVE:
                return 0.0
            return time.time() - self.started_at

    # -- lifecycle -----------------------------------------------------------
    def _build(self) -> None:
        from ..runtime.parse import parse_launch

        self.pipeline = parse_launch(self.spec.launch)
        self.pipeline.name = f"svc:{self.name}"
        self.pipeline.add_state_listener(self._on_pipeline_event)

    def start(self, wait: bool = True) -> "Service":
        """REGISTERED/STOPPED → STARTING → READY. Blocks (``wait``) until
        READY or ``warmup_timeout_s``; a service that misses the window
        stays STARTING and is promoted by the monitor when warmup lands."""
        with self._lock:
            if self.state in _ACTIVE:
                return self
            if self.state is ServiceState.DRAINING:
                raise ServiceError(f"service '{self.name}' is draining")
            self.supervisor.reset()  # fresh supervision epoch: breaker and
            # crash window forget previous runs on an operator start
            self._set_state(ServiceState.STARTING, "start requested")
            self._eos_seen = False
            self._drained_evt.clear()
            if self.pipeline is None:
                self._build()
            self.started_at = time.time()
            self.pipeline.play()
            # AFTER play(): play resets sink_buffer_count, and the monitor
            # only trusts a progress reading taken under the new generation
            # — a stale pre-restart count can never satisfy warmup
            self.generation += 1
            if self._monitor is None:
                self._monitor = HealthMonitor(self)
                self._monitor.start()
            self._monitor.reset_watchdog()
        if self.spec.warmup == "none":
            self._mark_ready()
        elif wait:
            self._ready_evt.wait(self.spec.warmup_timeout_s)
        return self

    def _mark_ready(self, generation: Optional[int] = None) -> None:
        with self._lock:
            if self.state is not ServiceState.STARTING or self._restarting:
                return
            if generation is not None and generation != self.generation:
                return  # promotion decided against a previous run's counter
            self._set_state(ServiceState.READY,
                            "caps negotiated + warmup inference done"
                            if self.spec.warmup == "first-buffer"
                            else "warmup=none")
        self.supervisor.note_healthy()

    def mark_degraded_external(self, reason: str) -> bool:
        """READY → DEGRADED on an external verdict — the SLO engine's
        burn-rate breach (obs/slo.py). Unlike :meth:`_mark_degraded`
        this does NOT notify the supervisor: an SLO breach is overload,
        not a crash, and a restart would only add cold-start pain. The
        pipeline keeps serving; routers and the fabric's health tick see
        ``readiness() == False`` and shift load away. Returns True when
        the flip happened (False when the service was not READY)."""
        with self._lock:
            if self.state is not ServiceState.READY:
                return False
            self._set_state(ServiceState.DEGRADED, reason)
        tail = obs_flight.dump(last=12)
        logger.warning(
            "service %s DEGRADED by external verdict (%s); flight tail: %s",
            self.name, reason,
            "; ".join(f"{e['kind']}:{e['name']}" for e in tail) or "(empty)")
        return True

    def mark_recovered(self, reason: str) -> bool:
        """DEGRADED → READY when the external verdict clears (the SLO
        engine recovers only services IT degraded — a stall-watchdog
        DEGRADED, which has a supervisor restart pending, is never
        short-circuited here). Returns True when the flip happened."""
        with self._lock:
            if self.state is not ServiceState.DEGRADED:
                return False
            self._set_state(ServiceState.READY, reason)
        self.supervisor.note_healthy()
        return True

    def _mark_degraded(self, reason: str) -> None:
        """Watchdog verdict: still playing, no longer serving. The
        supervisor decides whether DEGRADED becomes a restart."""
        with self._lock:
            if self.state is not ServiceState.READY:
                return
            self._set_state(ServiceState.DEGRADED, reason)
        # answer "why did it stall" from history that was already being
        # recorded: dump the flight-recorder tail at the transition (the
        # supervisor's CrashReport embeds a longer one)
        tail = obs_flight.dump(last=12)
        logger.warning(
            "service %s DEGRADED (%s); flight tail: %s", self.name, reason,
            "; ".join(f"{e['kind']}:{e['name']}" for e in tail) or "(empty)")
        self.supervisor.notify_crash("stall", reason)

    def stop(self) -> "Service":
        """Hard stop: no drain, in-flight buffers are dropped."""
        with self._lock:
            self.supervisor.cancel()
            pipe = self.pipeline
        # stop OUTSIDE the lock: Pipeline.stop joins element threads, and
        # a dying element thread may be delivering _on_pipeline_event —
        # which takes this lock. Holding it across the join would stall
        # every stop on the event thread's 5s join timeout.
        if pipe is not None and pipe.playing:
            pipe.stop()
        self._stop_query_server()
        with self._lock:
            if self.state is not ServiceState.FAILED:
                self._set_state(ServiceState.STOPPED, "stop requested")
        return self

    def drain(self, timeout_s: float = 30.0) -> "Service":
        """Graceful shutdown: sources stop producing and send EOS, queued
        work flushes through the sinks, then the pipeline stops."""
        with self._lock:
            active = self.state in _ACTIVE
            if active:
                self.supervisor.cancel()
                self._set_state(ServiceState.DRAINING, "drain requested")
                pipe = self.pipeline
        if not active:
            # outside the with: stop() re-enters the RLock but must run
            # its pipeline join with the lock COUNT at zero, or the
            # join-vs-listener stall it was restructured to avoid returns
            return self.stop()
        for src in pipe.sources:
            try:
                src.stop()
                src.send_eos()
            except Exception:  # noqa: BLE001 - drain every source regardless
                logger.exception("service %s: draining %s failed",
                                 self.name, src.name)
        if not self._drained_evt.wait(timeout_s):
            logger.warning("service %s: drain timed out after %.1fs, "
                           "stopping anyway", self.name, timeout_s)
        pipe.stop()  # outside the lock — joins element threads (see stop())
        self._stop_query_server()
        with self._lock:
            self._set_state(ServiceState.STOPPED, "drained")
        return self

    def _stop_query_server(self) -> None:
        """Detach under the lock, stop OUTSIDE it: QueryServer.stop joins
        accept/serve/client threads (seconds of join timeouts worst-case),
        and holding Service._lock across that starves the monitor tick and
        every control call on this service."""
        with self._lock:
            server, self._query_server = self._query_server, None
        if server is not None:
            try:
                server.stop()
            except Exception:  # noqa: BLE001
                pass

    def shutdown(self) -> None:
        """stop() + monitor/supervisor thread teardown (service is being
        unregistered). Every control-plane thread this service started is
        JOINED here — no daemon-thread leaks across unregister."""
        self.stop()
        with self._lock:
            monitor, self._monitor = self._monitor, None
        # joins happen with no lock held: the monitor tick and the
        # supervisor's timer/give-up threads all take Service._lock
        if monitor is not None:
            monitor.stop()
            monitor.join(timeout=2.0)
        self.supervisor.join_threads()

    # -- pipeline events -----------------------------------------------------
    def _on_pipeline_event(self, kind: str, source: str, data: dict) -> None:
        if kind == "error":
            with self._lock:
                if self.state is ServiceState.DRAINING:
                    self._drained_evt.set()  # died mid-drain: unblock
                    return
                if self.state not in _ACTIVE:
                    return
            self.supervisor.notify_crash(
                "error", str(data.get("error", data)), source)
        elif kind == "eos":
            with self._lock:
                self._eos_seen = True
                if self.state is ServiceState.DRAINING:
                    self._drained_evt.set()
                    return
                if self.state not in _ACTIVE:
                    return
            self.supervisor.notify_eos()

    # -- supervisor callbacks ------------------------------------------------
    def _supervised_restart(self) -> None:
        with self._lock:
            if self.state not in _ACTIVE:
                return  # user stopped/drained/failed meanwhile
            logger.info("service %s: supervised restart (#%d)",
                        self.name, self.supervisor.restarts)
            self._set_state(ServiceState.STARTING,
                            f"supervised restart #{self.supervisor.restarts}")
            self._eos_seen = False
            self._restarting = True  # blocks READY promotion (see __init__)
            pipe = self.pipeline
        # stop/play outside the lock: stop() joins the dying run's element
        # threads, which may be mid-_on_pipeline_event (takes our lock)
        pipe.stop()
        pipe.play()
        stale = False
        with self._lock:
            self._restarting = False
            if self.state is not ServiceState.STARTING:
                stale = True  # user stopped/drained while we replayed
            else:
                self.started_at = time.time()
                self.generation += 1  # after play(): see start()
                if self._monitor is not None:
                    self._monitor.reset_watchdog()
        if stale:
            pipe.stop()

    def _supervised_give_up(self, why: str) -> None:
        with self._lock:
            pipe = self.pipeline
        if pipe is not None and pipe.playing:
            pipe.stop()  # outside the lock — joins element threads
        with self._lock:
            self._set_state(ServiceState.FAILED, why)

    def _supervised_complete(self) -> None:
        """Clean EOS under a non-restarting policy: the stream is over."""
        with self._lock:
            if self.state not in _ACTIVE:
                return
            self._set_state(ServiceState.STOPPED, "stream completed (eos)")
            pipe = self.pipeline
        pipe.stop()  # outside the lock — joins element threads

    # -- integration ---------------------------------------------------------
    def attach_query_server(self, host: str = "127.0.0.1", port: int = 0,
                            priority: int = 0,
                            deadline_s: Optional[float] = None):
        """Expose the service's ``tensor_serving`` scheduler to TCP
        tensor-query clients: N clients coalesce into the service's device
        batch (query/server.py attach_scheduler). Returns the QueryServer
        (``.port`` for clients); stopped with the service."""
        from ..query.server import QueryServer

        el = self._find_serving_element()
        server = QueryServer(host, port)
        server.attach_scheduler(el._ensure_scheduler(), priority=priority,
                                deadline_s=deadline_s)
        with self._lock:
            self._query_server = server
        return server

    def _find_serving_element(self):
        from ..elements.serving import TensorServing

        if self.pipeline is None:
            raise ServiceError(
                f"service '{self.name}' is not built yet (start it first)")
        for el in self.pipeline.elements.values():
            if isinstance(el, TensorServing):
                return el
        raise ServiceError(
            f"service '{self.name}' has no tensor_serving element to "
            "attach a query server to")

    def model_bindings(self) -> dict:
        """{slot: version info} for every slot this service references."""
        out = {}
        if self.pipeline is None:
            return out
        slots = self.manager.models
        for slot in slots.names():
            for svc, _el in slots.bound_filters(slot):
                if svc is self:
                    out[slot] = slots.info(slot)
                    break
        return out

    def status(self) -> dict:
        return service_snapshot(self)


class ServiceManager:
    """The named-service table + model slots (one per deployment)."""

    def __init__(self, jitter_seed: Optional[int] = None):
        self._lock = named_lock("ServiceManager._lock")
        self._services: Dict[str, Service] = {}  # guarded-by: _lock
        self._jitter_seed = jitter_seed
        self.models = ModelSlots(self)
        # managed services join the metrics plane (nns_service_* at the
        # control plane's GET /metrics route)
        obs_metrics.track_manager(self)

    # -- registration --------------------------------------------------------
    def register(self, name: str, launch: Optional[str] = None, *,
                 pbtxt: Optional[str] = None,
                 restart: Optional[RestartPolicy] = None,
                 watchdog_s: float = 0.0,
                 warmup: str = "first-buffer",
                 warmup_timeout_s: float = 30.0,
                 lint: str = "error",
                 description: str = "",
                 autostart: bool = False) -> Service:
        """Admit a named service from a launch line or pbtxt graph.

        ``lint``: ``error`` (default — error findings reject), ``warn``
        (everything logs, nothing rejects), ``off`` (skip the linter).
        """
        if (launch is None) == (pbtxt is None):
            raise ValueError("pass exactly one of launch= or pbtxt=")
        if lint not in ("error", "warn", "off"):
            raise ValueError(f"lint '{lint}' must be error|warn|off")
        if pbtxt is not None:
            from ..runtime.pbtxt import from_pbtxt

            launch = from_pbtxt(pbtxt)
        with self._lock:
            if name in self._services:
                raise ServiceError(f"service '{name}' already registered")
        if lint != "off":
            self._admission_lint(name, launch, strict=(lint == "error"))
        spec = ServiceSpec(name=name, launch=launch,
                           restart=restart or RestartPolicy(),
                           watchdog_s=watchdog_s, warmup=warmup,
                           warmup_timeout_s=warmup_timeout_s,
                           description=description)
        svc = Service(self, spec, jitter_seed=self._jitter_seed)
        with self._lock:
            if name in self._services:
                raise ServiceError(f"service '{name}' already registered")
            self._services[name] = svc
        logger.info("service %s: registered (%s)", name,
                    launch[:120])
        if autostart:
            svc.start()
        return svc

    @staticmethod
    def _admission_lint(name: str, launch: str, strict: bool) -> None:
        from ..analysis import Severity, lint_launch

        try:
            diags = lint_launch(launch)
        except Exception:  # noqa: BLE001 - the linter must not block ops
            logger.exception("service %s: admission lint failed to run",
                             name)
            return
        errors = [d for d in diags if d.is_error]
        for d in diags:
            if d.severity is Severity.INFO:
                # NNL013 fusion-plan reports: what the service pipeline
                # will fuse at play() — operational info, not a hazard
                logger.info("service %s admission lint: %s", name,
                            d.format())
            elif d not in errors or not strict:
                logger.warning("service %s admission lint: %s", name,
                               d.format())
        if strict and errors:
            raise AdmissionRejected(name, errors)

    # -- table ---------------------------------------------------------------
    def get(self, name: str) -> Service:
        with self._lock:
            svc = self._services.get(name)
        if svc is None:
            raise ServiceError(f"unknown service '{name}' "
                               f"(have: {sorted(self._services)})")
        return svc

    def services(self) -> List[Service]:
        with self._lock:
            return list(self._services.values())

    def list(self) -> List[dict]:
        return [{"name": s.name, "state": s.state.value,
                 "ready": s.readiness(), "restarts": s.supervisor.restarts,
                 "description": s.spec.description}
                for s in self.services()]

    def unregister(self, name: str) -> None:
        svc = self.get(name)
        svc.shutdown()
        with self._lock:
            self._services.pop(name, None)

    # -- verbs (CLI/HTTP surface) -------------------------------------------
    def start(self, name: str, wait: bool = True) -> Service:
        return self.get(name).start(wait=wait)

    def stop(self, name: str) -> Service:
        return self.get(name).stop()

    def drain(self, name: str, timeout_s: float = 30.0) -> Service:
        return self.get(name).drain(timeout_s)

    def status(self, name: str) -> dict:
        return self.get(name).status()

    def swap(self, slot: str, version: str) -> dict:
        return self.models.swap(slot, version)

    def shutdown(self) -> None:
        """Stop everything, tear down monitors, unpublish model slots."""
        for svc in self.services():
            try:
                svc.shutdown()
            except Exception:  # noqa: BLE001 - shut the rest down regardless
                logger.exception("service %s: shutdown failed", svc.name)
        self.models.unpublish_all()
        with self._lock:
            self._services.clear()
        # explicit unregister sweep: a retired manager's nns_service_*
        # rows must leave the scrape now, not when GC collects the weak
        # tracking ref
        obs_metrics.untrack_manager(self)
