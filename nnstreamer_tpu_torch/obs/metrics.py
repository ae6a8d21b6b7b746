"""Unified metrics plane: registry, instruments, Prometheus text (L7).

The port of nnstreamer_tpu's ``obs/metrics.py``: every subsystem publishes
into ONE registry, rendered as Prometheus text exposition by
:func:`render`.

Two publishing styles:

* **direct instruments** — ``counter()/gauge()/histogram()`` get-or-create
  named instruments; callers ``inc()/set()/observe()`` (one dict update
  under a small lock);
* **collectors** — snapshot-shaped sources (a live scheduler, a replica
  pool, a service manager, a KV page pool) are *tracked weakly* and read
  at scrape time: nothing on their hot paths changes, the scrape pays the
  snapshot cost. ``register_collector()`` adds custom sources.

The built-in collectors cover serving schedulers (``nns_serving_*``),
fabric pools (``nns_fabric_*``), services (``nns_service_*``) and
the obs plane itself (``nns_flight_events_total``,
``nns_trace_spans_total``, ``nns_tracing_enabled``); the serving modules
add the KV pool's and speculation's gauges, ``obs/memory.py`` the
``nns_memory_*`` ones, ``obs/profile.py``, ``obs/quality.py`` and
``obs/slo.py`` theirs; the fused-segment collector (``nns_fused_*``)
reads the pipelines' segments and the wire collector (``nns_wire_*``,
``nns_shm_*``) ``transport/stats.py``, and the kernels collector the
launch counts of the hand-written CUDA kernels
(``nns_kernel_launches_total``, the port's own: the reference has no
such kernels).
"""
from __future__ import annotations

import re
import threading
import weakref
from typing import Callable, Dict, List, Sequence, Tuple

from ..analysis import sanitizer as _san


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricError(ValueError):
    pass


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Instrument:
    KIND = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name '{name}'")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"invalid label name '{ln}' on {name}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise MetricError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(_escape_label(labels[ln]) for ln in self.labelnames)

    def _set(self, value: float, labels: dict) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def clear(self) -> None:
        """Drop every sample. Snapshot-mirroring collectors call this
        before repopulating each scrape, so a series whose SOURCE is gone
        (deregistered service, removed replica, a state a service is no
        longer in) disappears instead of reporting its last value
        forever. Never call on directly-incremented instruments."""
        with self._lock:
            self._values.clear()

    def samples(self) -> List[Tuple[str, tuple, float]]:
        """(suffix, label values, value) rows for rendering."""
        with self._lock:
            return [("", k, v) for k, v in sorted(self._values.items())]

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.KIND}"]
        for suffix, key, value in self.samples():
            labels = ""
            if key or suffix:
                pairs = [f'{ln}="{lv}"'
                         for ln, lv in zip(self.labelnames, key[:len(
                             self.labelnames)])]
                pairs += list(key[len(self.labelnames):])  # histogram le=
                labels = "{" + ",".join(pairs) + "}" if pairs else ""
            lines.append(f"{self.name}{suffix}{labels} {_fmt_value(value)}")
        return lines


class Counter(_Instrument):
    """Monotonic counter. ``inc`` accumulates; ``set_total`` mirrors an
    externally-maintained monotonic total (the collector style — the
    source of truth keeps its own counter, we just expose it)."""

    KIND = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        self._set(value, labels)


class Gauge(_Instrument):
    KIND = "gauge"

    def set(self, value: float, **labels) -> None:
        self._set(value, labels)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics: ``le`` buckets
    + ``_sum`` + ``_count``)."""

    KIND = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
    # SLO-aligned presets (docs/observability.md#histogram-buckets).
    # STAGE: per-element hops / fused dispatches / queue waits — dense
    # 100 µs–100 ms resolution where stage-latency objectives live, so a
    # bucket edge sits ON every common threshold (1/2.5/5/10/25/50 ms)
    # and burn-rate queries never interpolate across an edge.
    LATENCY_BUCKETS_STAGE = (0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                             0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                             1.0)
    # REQUEST: end-to-end request latency incl. retries/hedges/queueing —
    # edges on the common request SLO thresholds (10/25/50/100/250/500 ms,
    # 1/2.5 s) plus a long tail for timeout forensics.
    LATENCY_BUCKETS_REQUEST = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                               0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(buckets))
        # per label-set: [bucket counts..., +Inf count, sum]
        self._hists: Dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            cell = self._hists.get(key)
            if cell is None:
                cell = self._hists[key] = [0] * (len(self.buckets) + 1) + [0.0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    cell[i] += 1
            cell[len(self.buckets)] += 1  # +Inf / _count
            cell[-1] += float(value)

    def clear(self) -> None:
        with self._lock:
            self._hists.clear()

    def samples(self) -> List[Tuple[str, tuple, float]]:
        rows: List[Tuple[str, tuple, float]] = []
        with self._lock:
            items = sorted(self._hists.items())
        for key, cell in items:
            for i, b in enumerate(self.buckets):
                rows.append(("_bucket", key + (f'le="{b}"',), cell[i]))
            rows.append(("_bucket", key + ('le="+Inf"',),
                         cell[len(self.buckets)]))
            rows.append(("_sum", key, cell[-1]))
            rows.append(("_count", key, cell[len(self.buckets)]))
        return rows


class Registry:
    """Named instruments + scrape-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}
        self._collectors: Dict[str, Callable[["Registry"], None]] = {}

    def _get_or_create(self, cls, name: str, help_text: str,
                       labelnames: Sequence[str], **kw):
        with self._lock:
            inst = self._metrics.get(name)
            if inst is None:
                inst = self._metrics[name] = cls(name, help_text,
                                                 labelnames, **kw)
            elif not isinstance(inst, cls) or (
                    inst.labelnames != tuple(labelnames)):
                raise MetricError(
                    f"metric '{name}' already registered as "
                    f"{type(inst).__name__}{inst.labelnames}")
            return inst

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = Histogram.DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labelnames,
                                   buckets=buckets)

    def register_collector(self, name: str,
                           fn: Callable[["Registry"], None]) -> None:
        """``fn(registry)`` runs at every :meth:`render`; it reads its
        sources and sets instrument values. Re-registering a name
        replaces the collector."""
        with self._lock:
            self._collectors[name] = fn

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        from ..utils.log import logger

        with self._lock:
            collectors = list(self._collectors.items())
        for name, fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - one bad source must not
                # take the whole scrape down
                logger.exception("obs metrics: collector '%s' failed", name)
        with self._lock:
            instruments = sorted(self._metrics.items())
        lines: List[str] = []
        for _name, inst in instruments:
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"


# -- the default registry + weakly-tracked sources ---------------------------

default_registry = Registry()


def counter(name: str, help_text: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return default_registry.counter(name, help_text, labelnames)


def gauge(name: str, help_text: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return default_registry.gauge(name, help_text, labelnames)


def histogram(name: str, help_text: str = "",
              labelnames: Sequence[str] = (),
              buckets: Sequence[float] = Histogram.DEFAULT_BUCKETS
              ) -> Histogram:
    return default_registry.histogram(name, help_text, labelnames, buckets)


def register_collector(name: str, fn) -> None:
    default_registry.register_collector(name, fn)


def render() -> str:
    return default_registry.render()


# sources register themselves weakly at construction; the collectors
# below read whatever is still alive at scrape time
_tracked_pools: "weakref.WeakSet" = weakref.WeakSet()


_tracked_managers: "weakref.WeakSet" = weakref.WeakSet()
_tracked_pipelines: "weakref.WeakSet" = weakref.WeakSet()


def track_pool(pool) -> None:
    """Called by ``ReplicaPool.__init__`` — pools join the metrics plane
    (and ``serving.metrics_snapshot()``'s fabric fold) automatically."""
    _tracked_pools.add(pool)


def track_manager(manager) -> None:
    _tracked_managers.add(manager)
    if _san.LEAK:
        _san.note_acquire("metrics_registration", f"manager:{id(manager):x}",
                          idempotent=True)



def track_pipeline(pipeline) -> None:
    """Pipelines whose per-pipeline rows a collector reads:
    ``fusion.install`` tracks every pipeline that fused a segment, and
    the ``fused`` collector renders each segment's counters."""
    _tracked_pipelines.add(pipeline)
    if _san.LEAK:
        _san.note_acquire("metrics_registration",
                          f"pipeline:{id(pipeline):x}", idempotent=True,
                          detail=getattr(pipeline, "name", ""))


def untrack_pipeline(pipeline) -> None:
    """Explicit unregister sweep (``Pipeline.stop()``): the tracked set
    is weak, but weakness only helps once GC happens to run — until then
    a stopped pipeline's stale rows would keep rendering at every
    scrape."""
    _tracked_pipelines.discard(pipeline)
    if _san.LEAK:
        _san.note_release("metrics_registration",
                          f"pipeline:{id(pipeline):x}")


def untrack_manager(manager) -> None:
    _tracked_managers.discard(manager)
    if _san.LEAK:
        _san.note_release("metrics_registration", f"manager:{id(manager):x}")


def pools_snapshot() -> Dict[str, dict]:
    """{pool_name: ReplicaPool.snapshot()} over every live pool — the
    fabric half of ``serving.metrics_snapshot()`` (per-replica in-flight,
    EWMA health score, evict/readmit/hedge counters in one read)."""
    from ..utils.log import logger

    out: Dict[str, dict] = {}
    for pool in list(_tracked_pools):
        try:
            snap = pool.snapshot()
        except Exception:  # noqa: BLE001 - a closing pool must not break
            # the snapshot the autoscaler polls
            logger.exception("obs metrics: pool snapshot failed")
            continue
        name = snap.get("name", "pool")
        if name in out:  # two pools under one name: keep both visible
            name = f"{name}#{sum(1 for k in out if k.startswith(name))}"
        out[name] = snap
    return out


# -- built-in collectors -----------------------------------------------------

def _collect_serving(reg: Registry) -> None:
    from ..serving import metrics as serving_metrics

    subm = reg.counter("nns_serving_submitted_total",
                       "requests submitted to a scheduler", ("scheduler",))
    comp = reg.counter("nns_serving_completed_total",
                       "requests completed", ("scheduler",))
    fail = reg.counter("nns_serving_failed_total",
                       "requests failed in execution", ("scheduler",))
    shedf = reg.counter("nns_serving_shed_queue_full_total",
                        "requests shed: queue depth", ("scheduler",))
    shedd = reg.counter("nns_serving_shed_deadline_total",
                        "requests shed: deadline budget", ("scheduler",))
    shedm = reg.counter("nns_serving_shed_memory_total",
                        "requests shed: projected memory watermark",
                        ("scheduler",))
    shedo = reg.counter("nns_serving_shed_overload_total",
                        "requests shed: overload guard (autoscaler at "
                        "ceiling)", ("scheduler",))
    batches = reg.counter("nns_serving_batches_total",
                          "device batches executed", ("scheduler",))
    depth = reg.gauge("nns_serving_queue_depth",
                      "requests queued right now", ("scheduler",))
    occ = reg.gauge("nns_serving_batch_occupancy",
                    "real rows / padded rows", ("scheduler",))
    wait = reg.gauge("nns_serving_estimated_wait_seconds",
                     "EWMA-predicted queue wait", ("scheduler",))
    p99 = reg.gauge("nns_serving_latency_p99_seconds",
                    "total request latency p99 (recent window)",
                    ("scheduler",))
    # snapshot mirrors: repopulated from live schedulers each scrape, so
    # a garbage-collected scheduler's series disappears with it
    for inst in (subm, comp, fail, shedf, shedd, shedm, shedo, batches,
                 depth, occ, wait, p99):
        inst.clear()
    for name, sched in serving_metrics.iter_schedulers():
        try:
            snap = sched.metrics_snapshot()
        except Exception:  # noqa: BLE001 - scheduler mid-close
            continue
        subm.set_total(snap.get("submitted", 0), scheduler=name)
        comp.set_total(snap.get("completed", 0), scheduler=name)
        fail.set_total(snap.get("failed", 0), scheduler=name)
        shedf.set_total(snap.get("shed_queue_full", 0), scheduler=name)
        shedd.set_total(snap.get("shed_deadline", 0), scheduler=name)
        shedm.set_total(snap.get("shed_memory", 0), scheduler=name)
        shedo.set_total(snap.get("shed_overload", 0), scheduler=name)
        batches.set_total(snap.get("batches", 0), scheduler=name)
        depth.set(snap.get("queue_depth", 0), scheduler=name)
        occ.set(snap.get("batch_occupancy", 0.0), scheduler=name)
        wait.set(snap.get("estimated_wait_ms", 0.0) / 1e3, scheduler=name)
        p99.set(snap.get("total_latency", {}).get("p99_ms", 0.0) / 1e3,
                scheduler=name)


def _collect_fabric(reg: Registry) -> None:
    pool_counters = {
        "requests": reg.counter("nns_fabric_requests_total",
                                "requests routed through a pool", ("pool",)),
        "retries": reg.counter("nns_fabric_retries_total",
                               "attempts retried on another replica",
                               ("pool",)),
        "hedges": reg.counter("nns_fabric_hedges_total",
                              "hedge duplicates fired", ("pool",)),
        "hedge_wins": reg.counter("nns_fabric_hedge_wins_total",
                                  "hedges that answered first", ("pool",)),
        "request_errors": reg.counter("nns_fabric_request_errors_total",
                                      "requests failed after all attempts",
                                      ("pool",)),
        "evictions": reg.counter("nns_fabric_evictions_total",
                                 "replica evictions", ("pool",)),
        "readmissions": reg.counter("nns_fabric_readmissions_total",
                                    "replica readmissions", ("pool",)),
        "spills": reg.counter("nns_fabric_spills_total",
                              "bounded-load ring spills", ("pool",)),
    }
    inflight = reg.gauge("nns_fabric_inflight",
                         "in-flight requests", ("pool",))
    r_inflight = reg.gauge("nns_fabric_replica_inflight",
                           "per-replica in-flight requests",
                           ("pool", "replica"))
    r_score = reg.gauge("nns_fabric_replica_score",
                        "per-replica EWMA health score",
                        ("pool", "replica"))
    r_up = reg.gauge("nns_fabric_replica_up",
                     "1 = ACTIVE, 0 = quarantined/draining",
                     ("pool", "replica"))
    # snapshot mirrors (NOT the request-latency histogram, which is
    # directly observed): closed pools / removed replicas drop out
    for inst in list(pool_counters.values()) + [inflight, r_inflight,
                                                r_score, r_up]:
        inst.clear()
    for name, snap in pools_snapshot().items():
        for key, inst in pool_counters.items():
            inst.set_total(snap.get(key, 0), pool=name)
        inflight.set(snap.get("inflight_total", 0), pool=name)
        for rep in snap.get("replicas", []):
            rid = rep.get("id", "?")
            r_inflight.set(rep.get("inflight", 0), pool=name, replica=rid)
            r_score.set(rep.get("score", 0.0), pool=name, replica=rid)
            r_up.set(1.0 if rep.get("state") == "active" else 0.0,
                     pool=name, replica=rid)


def _collect_services(reg: Registry) -> None:
    up = reg.gauge("nns_service_up", "1 = READY", ("service",))
    state = reg.gauge("nns_service_state",
                      "1 for the service's current state",
                      ("service", "state"))
    restarts = reg.counter("nns_service_restarts_total",
                           "supervised restarts", ("service",))
    sink = reg.counter("nns_service_sink_buffers_total",
                       "buffers rendered at sinks since last play",
                       ("service",))
    # snapshot mirrors: without the clear, nns_service_state would keep
    # reporting 1 for every state a service was EVER in, and a
    # deregistered service would stay "up" forever
    for inst in (up, state, restarts, sink):
        inst.clear()
    for mgr in list(_tracked_managers):
        try:
            services = mgr.services()
        except Exception:  # noqa: BLE001 - manager mid-shutdown
            continue
        for svc in services:
            up.set(1.0 if svc.readiness() else 0.0, service=svc.name)
            state.set(1.0, service=svc.name, state=svc.state.value)
            restarts.set_total(svc.supervisor.restarts, service=svc.name)
            pipe = svc.pipeline
            if pipe is not None:
                sink.set_total(pipe.sink_buffer_count, service=svc.name)


def _collect_fused(reg: Registry) -> None:
    disp = reg.counter("nns_fused_dispatches_total",
                       "single-dispatch segment executions (graph replays "
                       "on the card)", ("pipeline", "segment"))
    retr = reg.counter("nns_fused_retraces_total",
                       "segment captures (one CUDA graph per input "
                       "signature)", ("pipeline", "segment"))
    defu = reg.counter("nns_fused_defused_total",
                       "runtime fallbacks to per-element dispatch",
                       ("pipeline", "segment"))
    probe = reg.gauge("nns_fused_probe_device_seconds",
                      "last sampled device-complete latency",
                      ("pipeline", "segment"))
    for inst in (disp, retr, defu, probe):  # snapshot mirrors
        inst.clear()
    for pipe in list(_tracked_pipelines):
        for seg in getattr(pipe, "fused_segments", []):
            st = seg.stats
            disp.set_total(st.get("dispatches", 0), pipeline=pipe.name,
                           segment=seg.name)
            retr.set_total(st.get("retraces", 0), pipeline=pipe.name,
                           segment=seg.name)
            defu.set_total(st.get("defused", 0), pipeline=pipe.name,
                           segment=seg.name)
            probe.set(st.get("probe_device_s", 0.0), pipeline=pipe.name,
                      segment=seg.name)


def _collect_wire(reg: Registry) -> None:
    """Data-plane counters (transport/stats.py): negotiated wire formats,
    frames/bytes per format+direction, shm ring events, and the card
    bytes the encoder pulled. A fleet silently stuck on the JSON fallback
    shows up here."""
    from ..transport import stats as wire_stats

    conn = reg.gauge("nns_wire_connections",
                     "open query connections by negotiated wire format",
                     ("format",))
    neg = reg.counter("nns_wire_negotiated_total",
                      "handshakes completed by selected wire format",
                      ("format",))
    frames = reg.counter("nns_wire_frames_total",
                         "DATA frames moved", ("format", "direction"))
    nbytes = reg.counter("nns_wire_bytes_total",
                         "DATA payload bytes moved (shm frames count their "
                         "slot bytes, not the descriptor)",
                         ("format", "direction"))
    shm = reg.counter("nns_shm_events_total",
                      "shared-memory ring events (slot_writes, bytes, "
                      "fallback_full, fallback_oversize, reclaimed_slots, "
                      "segments_created/attached/closed)", ("event",))
    for inst in (conn, neg, frames, nbytes, shm):  # snapshot mirrors
        inst.clear()
    snap = wire_stats.snapshot()
    for fmt, v in snap["connections"].items():
        conn.set(v, format=fmt)
    for fmt, v in snap["negotiated"].items():
        neg.set_total(v, format=fmt)
    for key, v in snap["frames"].items():
        fmt, direction = key.rsplit(":", 1)
        frames.set_total(v, format=fmt, direction=direction)
    for key, v in snap["bytes"].items():
        fmt, direction = key.rsplit(":", 1)
        nbytes.set_total(v, format=fmt, direction=direction)
    for event, v in snap["shm"].items():
        shm.set_total(v, event=event)
    d2h = reg.counter("nns_wire_d2h_bytes_total",
                      "card tensor bytes the frame encoder pulled to the "
                      "host")
    d2h.clear()
    d2h.set_total(snap["d2h"].get("bytes", 0))


def _collect_obs(reg: Registry) -> None:
    from . import context, flight

    reg.counter("nns_flight_events_total",
                "events recorded by the flight recorder"
                ).set_total(flight.count())
    st = context.stats()
    reg.counter("nns_trace_spans_total",
                "spans finished since process start"
                ).set_total(st["finished_total"])
    reg.gauge("nns_tracing_enabled",
              "1 when request-scoped tracing is on"
              ).set(1.0 if st["tracing"] else 0.0)


# the hand-written CUDA kernels (ops/), by module: each wrapper counts
# its launches on the card (a CPU run counts none)
_KERNELS = ("decode_attention", "flash_attention", "fma_gemm",
            "depthwise_fma")


def _collect_kernels(reg: Registry) -> None:
    """``nns_kernel_launches_total{kernel}``: the launch counters of the
    kernels this process loaded — how a scrape shows that a served line
    really ran on them. A kernel module nothing imported is left out
    (the scrape imports nothing)."""
    import sys

    launches = reg.counter("nns_kernel_launches_total",
                           "hand-written CUDA kernel launches",
                           ("kernel",))
    launches.clear()
    pkg = __name__.rsplit(".", 2)[0]
    for name in _KERNELS:
        mod = sys.modules.get(f"{pkg}.ops.{name}")
        if mod is not None:
            launches.set_total(getattr(mod, name).launches, kernel=name)


register_collector("serving", _collect_serving)
register_collector("fabric", _collect_fabric)
register_collector("services", _collect_services)
register_collector("fused", _collect_fused)
register_collector("wire", _collect_wire)
register_collector("obs", _collect_obs)
register_collector("kernels", _collect_kernels)
