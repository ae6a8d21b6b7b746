"""Continuous profiler: streaming-quantile attribution + artifacts (L7).

The port of nnstreamer_tpu's ``obs/profile.py``. It interprets the obs
plane's signals continuously: wall time attributed per element, per
queue-wait hop and per served request, aggregated into mergeable
streaming-quantile digests, and persisted as **profile artifacts** keyed
by (topology hash, caps, model version). Digests, windows, topology
hashes and the artifact JSON are the reference's, byte for byte, so an
artifact saved by either package loads and merges in the other.

Attribution channels, all riding hooks that already exist:

* **elements** — a :class:`Tracer` installed by :func:`start` receives
  the per-hop elapsed time ``Pad.push`` already measures when tracing is
  active (``utils/trace.notify_flow``); nothing new on the pad path.
* **queue waits** — ``QueueElement`` stamps entry time and measures the
  wait at the worker pop (plus instantaneous depth), gated on one module
  global.
* **requests** — the serving schedulers record end-to-end request
  latency + outcome into *windowed* series (:class:`WindowedSeries`), the
  substrate the SLO engine (:mod:`.slo`) evaluates burn rates from.
* **fused segments** — ``FusedSegment.dispatch`` (runtime/fusion.py)
  records host dispatch time every buffer and the sampled
  device-complete time every ``PROBE_EVERY``-th (:func:`record_fused`:
  the ``fused`` / ``fused_device`` series).

Cost contract: with profiling off every hook is ONE module-global check
(:data:`ACTIVE`); enabled overhead is reported, not gated — turning the
profiler on is a deliberate trade, and the per-sample cost is two
timestamps plus one log-bucket insert.

Surfaces: :func:`snapshot`, :func:`render_top` and the
``nns_profile_*`` histograms of :mod:`.metrics`.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..analysis import sanitizer as _san
from ..analysis.sanitizer import named_lock
from . import metrics as obs_metrics

# module-global fast path: queue/fusion/serving/fabric hooks check this
# and only this when profiling is off (the microbench gate measures it)
ACTIVE = False


class QuantileDigest:
    """Mergeable streaming-quantile sketch: fixed-γ log buckets (the
    DDSketch construction) over positive values, stdlib-only.

    Accuracy guarantee (documented, tested): with relative accuracy
    ``alpha`` every bucket ``i`` covers ``(γ^(i-1), γ^i]`` for
    ``γ = (1+α)/(1-α)``, and the mid-bucket estimate ``2γ^i/(γ+1)`` is
    within ``α`` *relative* error of any value in the bucket — so any
    quantile estimate is within ``α·v`` of the exact sample quantile
    ``v`` (values at or below :data:`MIN_VALUE` collapse into a zero
    bucket and report 0.0).

    Merging is EXACT: two digests with the same ``alpha`` share bucket
    boundaries, so ``a.merge(b)`` is bucket-wise addition and equals the
    digest of the pooled samples bit-for-bit — replica digests aggregate
    without accuracy loss, the property profile artifacts and the SLO
    engine rely on.
    """

    __slots__ = ("alpha", "_gamma", "_lg", "_buckets", "_zero",
                 "count", "sum", "min", "max")

    MIN_VALUE = 1e-9  # seconds; below this resolution nothing is timed

    def __init__(self, alpha: float = 0.01):
        if not 0.0 < alpha < 0.5:
            raise ValueError(f"alpha={alpha} must be in (0, 0.5)")
        self.alpha = alpha
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def add(self, value: float, n: int = 1) -> None:
        v = float(value)
        if v < 0.0:
            v = 0.0  # durations; clock skew must not poison the sketch
        self.count += n
        self.sum += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.MIN_VALUE:
            self._zero += n
            return
        i = math.ceil(math.log(v) / self._lg)
        b = self._buckets
        b[i] = b.get(i, 0) + n

    def _bucket_value(self, i: int) -> float:
        return 2.0 * self._gamma ** i / (self._gamma + 1.0)

    def quantile(self, q: float) -> float:
        """The q-quantile estimate (q in [0, 1]); 0.0 on an empty digest."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} must be in [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        if rank < self._zero:
            return 0.0
        acc = self._zero
        for i in sorted(self._buckets):
            acc += self._buckets[i]
            if rank < acc:
                # clamp to the observed extremes: the edge buckets'
                # midpoints can only move INTO the α bound, never out
                return min(max(self._bucket_value(i), self.min), self.max)
        return self.max

    def count_above(self, threshold: float) -> int:
        """Samples greater than ``threshold`` — the SLO engine's "bad
        event" count. Exact up to the bucket holding the threshold
        (boundary error bounded by the same α)."""
        if self.count == 0:
            return 0
        if threshold <= self.MIN_VALUE:
            return self.count - self._zero
        k = math.ceil(math.log(threshold) / self._lg)
        return sum(c for i, c in self._buckets.items() if i > k)

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        """Fold ``other`` into this digest (in place; returns self)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge digests with alpha {self.alpha} != "
                f"{other.alpha} (bucket boundaries differ)")
        self.count += other.count
        self.sum += other.sum
        self._zero += other._zero
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        b = self._buckets
        for i, c in other._buckets.items():
            b[i] = b.get(i, 0) + c
        return self

    def copy(self) -> "QuantileDigest":
        d = QuantileDigest(self.alpha)
        d.merge(self)
        return d

    def to_dict(self) -> dict:
        return {
            "alpha": self.alpha,
            "count": self.count,
            "sum": self.sum,
            "zero": self._zero,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "buckets": {str(i): c for i, c in sorted(self._buckets.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileDigest":
        dig = cls(float(d["alpha"]))
        dig.count = int(d["count"])
        dig.sum = float(d["sum"])
        dig._zero = int(d["zero"])
        if d.get("min") is not None:
            dig.min = float(d["min"])
        if d.get("max") is not None:
            dig.max = float(d["max"])
        dig._buckets = {int(i): int(c) for i, c in d["buckets"].items()}
        return dig

    def __eq__(self, other) -> bool:
        """Sketch equality: same alpha, counts, and bucket contents —
        every quantile answer is identical. ``sum`` is deliberately
        excluded (float accumulation order differs between a merged and
        a pooled digest by ULPs)."""
        return (isinstance(other, QuantileDigest)
                and abs(self.alpha - other.alpha) < 1e-12
                and self.count == other.count
                and self._zero == other._zero
                and self._buckets == other._buckets
                and (self.count == 0
                     or (self.min == other.min and self.max == other.max)))

    def __repr__(self):
        return (f"QuantileDigest<n={self.count} p50="
                f"{self.quantile(0.5) * 1e3:.3f}ms "
                f"p99={self.quantile(0.99) * 1e3:.3f}ms>")


class WindowedSeries:
    """Request series bucketed into per-``resolution_s`` cells, each a
    (digest, ok, err) triple, on a ring covering ``horizon_s`` seconds.
    ``window(seconds)`` merges the trailing cells — because digest merge
    is exact, a 300-second window IS the digest of every sample in it.
    One series per (scheduler | pool | availability target); the SLO
    engine's multi-window burn rates and ``GET /profile`` read the same
    cells."""

    def __init__(self, alpha: float = 0.01, horizon_s: float = 900.0,
                 resolution_s: float = 1.0):
        if resolution_s <= 0:
            raise ValueError(f"resolution_s={resolution_s} must be > 0")
        self.alpha = alpha
        self.resolution_s = float(resolution_s)
        self._n = max(2, int(math.ceil(horizon_s / resolution_s)) + 1)
        # each slot: [epoch, digest, ok, err] — slot reuse is detected by
        # the stored epoch, so the ring never needs a sweeper
        self._cells: List[Optional[list]] = [None] * self._n
        self._lock = threading.Lock()
        self.total = QuantileDigest(alpha)     # guarded-by: _lock
        self.errors = 0                        # guarded-by: _lock

    def observe(self, value_s: float, ok: bool = True,
                now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        epoch = int(t / self.resolution_s)
        idx = epoch % self._n
        with self._lock:
            cell = self._cells[idx]
            if cell is None or cell[0] != epoch:
                cell = self._cells[idx] = [epoch, QuantileDigest(self.alpha),
                                           0, 0]
            cell[1].add(value_s)
            if ok:
                cell[2] += 1
            else:
                cell[3] += 1
                self.errors += 1
            self.total.add(value_s)

    def window(self, seconds: float, now: Optional[float] = None
               ) -> Tuple[QuantileDigest, int, int]:
        """(merged digest, ok count, err count) over the trailing
        ``seconds`` (including the current partial cell)."""
        t = time.monotonic() if now is None else now
        hi = int(t / self.resolution_s)
        lo = hi - max(1, int(math.ceil(seconds / self.resolution_s))) + 1
        merged = QuantileDigest(self.alpha)
        ok = err = 0
        with self._lock:
            for cell in self._cells:
                if cell is not None and lo <= cell[0] <= hi:
                    merged.merge(cell[1])
                    ok += cell[2]
                    err += cell[3]
        return merged, ok, err

    def snapshot(self) -> dict:
        with self._lock:
            dig = self.total.copy()
            errors = self.errors
        return {
            "count": dig.count,
            "errors": errors,
            "p50_ms": dig.quantile(0.5) * 1e3,
            "p99_ms": dig.quantile(0.99) * 1e3,
            "max_ms": (dig.max if dig.count else 0.0) * 1e3,
        }

    def export_state(self) -> dict:
        """Raw serializable form for cross-process aggregation (the
        ``GET /profile?raw=1`` route the fleet scraper reads): every
        live cell's digest + ok/err counts plus the cumulative total
        digest. Because digest merge is exact, a consumer that merges
        these cells gets bit-for-bit the digest of the pooled samples —
        the fleet p99 IS the pooled p99 (obs/fleet.py)."""
        with self._lock:
            cells = [{"epoch": c[0], "digest": c[1].to_dict(),
                      "ok": c[2], "err": c[3]}
                     for c in self._cells if c is not None]
            total = self.total.to_dict()
            errors = self.errors
        return {"alpha": self.alpha, "resolution_s": self.resolution_s,
                "cells": cells, "total": total, "errors": errors}


class _Series:
    """One duration-attribution channel: cumulative digest + rate anchors."""

    __slots__ = ("count", "total_s", "digest", "first_t", "last_t", "depth")

    def __init__(self, alpha: float):
        self.count = 0
        self.total_s = 0.0
        self.digest = QuantileDigest(alpha)
        self.first_t: Optional[float] = None
        self.last_t = 0.0
        self.depth: Optional[int] = None  # queues: level at last pop

    def snapshot(self) -> dict:
        d = self.digest
        span = (self.last_t - self.first_t) if self.first_t else 0.0
        out = {
            "count": self.count,
            "total_s": self.total_s,
            "rate_hz": (self.count - 1) / span if span > 0 else 0.0,
            "p50_ms": d.quantile(0.5) * 1e3,
            "p90_ms": d.quantile(0.9) * 1e3,
            "p99_ms": d.quantile(0.99) * 1e3,
            "max_ms": (d.max if d.count else 0.0) * 1e3,
        }
        if self.depth is not None:
            out["depth"] = self.depth
        return out


# the new profiler histograms publish into the metrics plane with the
# SLO-aligned bucket presets (docs/observability.md#histogram-buckets)
_STAGE_HIST = obs_metrics.histogram(
    "nns_profile_stage_seconds",
    "profiled stage duration (element hop / fused dispatch / queue wait)",
    ("scope", "stage"),
    buckets=obs_metrics.Histogram.LATENCY_BUCKETS_STAGE)
_REQUEST_HIST = obs_metrics.histogram(
    "nns_profile_request_seconds",
    "profiled end-to-end request latency per series",
    ("series",),
    buckets=obs_metrics.Histogram.LATENCY_BUCKETS_REQUEST)


class Profiler:
    """The process-wide attribution store. Duration scopes: ``element``
    (per pad hop, via the tracer), ``fused`` / ``fused_device`` (host
    dispatch / sampled device-complete, from FusedSegment), ``queue_wait``
    (queue entry → worker pop), ``serving`` (batch/step events). Names
    are ``<pipeline>:<element-or-segment>`` so artifacts can be captured
    per pipeline and merged across replicas."""

    def __init__(self, alpha: float = 0.01, horizon_s: float = 900.0):
        self.alpha = alpha
        self.horizon_s = horizon_s
        self._lock = named_lock("Profiler._lock")
        self._durations: Dict[Tuple[str, str], _Series] = {}  # guarded-by: _lock
        self._requests: Dict[str, WindowedSeries] = {}        # guarded-by: _lock

    # -- recording (hot when profiling is on) --------------------------------
    def observe(self, scope: str, name: str, seconds: float,
                depth: Optional[int] = None) -> None:
        now = time.monotonic()
        key = (scope, name)
        with self._lock:
            s = self._durations.get(key)
            if s is None:
                s = self._durations[key] = _Series(self.alpha)
            s.count += 1
            s.total_s += seconds
            s.digest.add(seconds)
            if s.first_t is None:
                s.first_t = now
            s.last_t = now
            if depth is not None:
                s.depth = depth
        _STAGE_HIST.observe(seconds, scope=scope, stage=name)

    def record_request(self, series: str, seconds: float, ok: bool = True,
                       now: Optional[float] = None) -> None:
        with self._lock:
            ws = self._requests.get(series)
            if ws is None:
                ws = self._requests[series] = WindowedSeries(
                    self.alpha, self.horizon_s)
        ws.observe(seconds, ok=ok, now=now)
        _REQUEST_HIST.observe(seconds, series=series)

    # -- reading -------------------------------------------------------------
    def series(self, scope: str, name: str) -> Optional[_Series]:
        with self._lock:
            return self._durations.get((scope, name))

    def request_series(self, series: str) -> Optional[WindowedSeries]:
        with self._lock:
            return self._requests.get(series)

    def request_window(self, series: str, seconds: float,
                       now: Optional[float] = None
                       ) -> Tuple[QuantileDigest, int, int]:
        ws = self.request_series(series)
        if ws is None:
            return QuantileDigest(self.alpha), 0, 0
        return ws.window(seconds, now=now)

    def snapshot(self) -> dict:
        """JSON-friendly view of every series (``GET /profile``). The
        duration rows are rendered UNDER the lock: quantile() iterates
        the live bucket dict, and a concurrent ``observe`` inserting a
        new bucket would otherwise blow the iteration up mid-scrape."""
        out: Dict[str, dict] = {}
        with self._lock:
            for (scope, name), s in sorted(self._durations.items()):
                out.setdefault(scope, {})[name] = s.snapshot()
            requests = dict(self._requests)
        return {
            "active": ACTIVE,
            "durations": out,
            # WindowedSeries.snapshot() locks per series internally
            "requests": {name: ws.snapshot()
                         for name, ws in sorted(requests.items())},
        }

    def export_state(self) -> dict:
        """Raw serializable export of every series (the fleet-scrape
        contract — docs/observability.md#fleet): duration digests as
        their bucket dicts and request series as windowed cells, plus
        the process's monotonic→wall clock offset so a scraper in
        ANOTHER process can align the cell epochs onto wall time.
        Everything is copied under the profiler lock (digest bucket
        dicts mutate under concurrent ``observe``)."""
        durations: Dict[str, dict] = {}
        with self._lock:
            for (scope, name), s in sorted(self._durations.items()):
                durations.setdefault(scope, {})[name] = {
                    "count": s.count,
                    "total_s": s.total_s,
                    "digest": s.digest.to_dict(),
                }
            requests = dict(self._requests)
        from . import context as obs_context

        return {
            "mono_to_wall": obs_context.mono_to_wall_offset(),
            "alpha": self.alpha,
            "durations": durations,
            # WindowedSeries.export_state locks per series internally
            "requests": {name: ws.export_state()
                         for name, ws in sorted(requests.items())},
        }

    def reset(self) -> None:
        with self._lock:
            self._durations.clear()
            self._requests.clear()


# -- canonical series naming --------------------------------------------------

def canonical_base(el) -> str:
    """The element's stable profile name: its own name when explicitly
    set, else a positional alias ``<type>@<index-in-pipeline>`` — the
    auto-generated name embeds a process-global instance counter, so a
    supervised restart or a sibling replica parsing the same launch line
    would get DIFFERENT names (and artifact keys/entries would never
    line up across the runs they are meant to merge over)."""
    if getattr(el, "auto_named", False):
        pipe = getattr(el, "pipeline", None)
        if pipe is not None:
            try:
                idx = list(pipe.elements).index(el.name)
            except ValueError:
                idx = -1
            return f"{el.ELEMENT_NAME}@{idx}"
    return el.name


def series_name(el) -> str:
    """``<pipeline>:<canonical-base>`` — cached on the element (the
    tracer/queue hot paths pay one attribute read after the first hit)."""
    cached = el.__dict__.get("_prof_series")
    if cached is None:
        pipe = getattr(el, "pipeline", None)
        cached = (f"{pipe.name if pipe is not None else '?'}:"
                  f"{canonical_base(el)}")
        el.__dict__["_prof_series"] = cached
    return cached


class _ProfilerTracer:
    """The element-attribution half: a ``utils.trace.Tracer`` receiving
    the per-hop elapsed time ``Pad.push`` already measures when any
    tracer is installed. Fused dispatches are recorded at their
    dispatch site (:func:`record_fused`, with their pipeline prefix), so
    the ``fused``-kind serving events are skipped here."""

    NAME = "profiler"

    def __init__(self, profiler: Profiler):
        self._p = profiler

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        peer = pad.peer
        if peer is None:
            return
        self._p.observe("element", series_name(peer.element), elapsed_s)

    def serving_event(self, kind: str, name: str, start_s: float,
                      dur_s: float, meta: dict) -> None:
        if kind == "fused":
            return  # recorded at the dispatch site with pipeline prefix
        self._p.observe("serving", f"{kind}:{name}", dur_s)

    def results(self) -> dict:
        return self._p.snapshot()


# -- module-level control (the API hot call sites use) -----------------------

default_profiler = Profiler()
_ctl_lock = threading.Lock()
_tracer: Optional[_ProfilerTracer] = None
# ACTIVE is the OR of three independent halves, so an explicit
# start()/stop() profiling session, a running SLO engine
# (enable_recording/disable_recording), and a placement-calibration
# window (begin_calibration/end_calibration, refcounted — several
# pipelines may calibrate concurrently) cannot starve each other:
# stop() ending a capture while an engine is alive must NOT silence the
# request series its burn rates are computed from, and a calibration
# finishing must not switch off another pipeline's window
_started = False        # guarded-by: _ctl_lock — start()/stop() sessions
_recording = False      # guarded-by: _ctl_lock — SLO-engine recording
_calibrating = 0        # guarded-by: _ctl_lock — placement calibrations


def profiler() -> Profiler:
    return default_profiler


def _update_active() -> None:
    global ACTIVE
    ACTIVE = _started or _recording or _calibrating > 0


#: the port's hand kernels (``ops/``): each wrapper counts its launches,
#: and an artifact captured from the default profiler records those made
#: since ``start()`` (a ``kernels`` section, present only when nonzero)
HAND_KERNELS = ("decode_attention", "flash_attention", "fma_gemm",
                "depthwise_fma")
_kernels_at_start: Dict[str, int] = {}


def kernel_launches() -> Dict[str, int]:
    """Each hand kernel's launch counter, as it stands."""
    import importlib

    return {name: int(getattr(importlib.import_module(
        f"..ops.{name}", __package__), name).launches)
        for name in HAND_KERNELS}


def start(elements: bool = True) -> Profiler:
    """Switch continuous profiling on. ``elements=True`` (default) also
    installs the pad-hop tracer for per-element attribution; queue-wait,
    fused-segment, and request recording activate either way."""
    global _started, _tracer
    from ..utils import trace

    with _ctl_lock:
        if elements and _tracer is None:
            _tracer = _ProfilerTracer(default_profiler)
            trace.install_tracer(_tracer)
        if not _started:
            _kernels_at_start.clear()
            _kernels_at_start.update(kernel_launches())
        _started = True
        _update_active()
    return default_profiler


def enable_recording() -> None:   # pairs-with: disable_recording
    """Queue/fused/request recording WITHOUT the per-hop element tracer —
    what the SLO engine needs. Independent of start()/stop(): a capture
    session ending does not switch a running engine's series off."""
    global _recording
    with _ctl_lock:
        if _san.LEAK and not _recording:
            # boolean half: ledger one unit per on→off transition
            _san.note_acquire("recording", "obs.profile")
        _recording = True
        _update_active()


def disable_recording() -> None:
    """The engine half's off switch (the last stopping SloEngine calls
    this)."""
    global _recording
    with _ctl_lock:
        if _san.LEAK and _recording:
            _san.note_release("recording", "obs.profile")
        _recording = False
        _update_active()


def begin_calibration() -> None:   # pairs-with: end_calibration
    """Placement-calibration recording (queue/fused hooks, no element
    tracer), REFCOUNTED: each ``begin`` must be paired with one ``end``,
    and concurrent calibrating pipelines keep recording alive until the
    last one finishes (runtime/placement.py's calibration window)."""
    global _calibrating
    with _ctl_lock:
        if _san.LEAK:
            _san.note_acquire("calibration", "obs.profile")
        _calibrating += 1
        _update_active()


def end_calibration() -> None:
    global _calibrating
    with _ctl_lock:
        if _san.LEAK:
            _san.note_release("calibration", "obs.profile")
        _calibrating = max(0, _calibrating - 1)
        _update_active()


def stop() -> None:
    """End a start() session: back to the one-global-check fast path
    unless an SLO engine still records (data is kept; reset() drops it)."""
    global _started, _tracer
    from ..utils import trace

    with _ctl_lock:
        _started = False
        _update_active()
        if _tracer is not None:
            trace.uninstall_tracer(_tracer)
            _tracer = None


def reset() -> None:
    default_profiler.reset()


def snapshot() -> dict:
    snap = default_profiler.snapshot()
    # NNS_XFERCHECK byte ledger: when the transfer sanitizer is armed,
    # per-(stage,direction) transfer bytes ride the same snapshot that
    # feeds GET /profile and `obs top` — one surface for "where do my
    # bytes cross the host/device (and process) boundary"
    if _san.XFER:
        snap["transfers"] = _san.xfer_transfers()
    return snap


def export_state() -> dict:
    """Raw digest export of the default profiler (the fleet-scrape
    contract; ``GET /profile?raw=1``)."""
    return default_profiler.export_state()


# hot call sites (queue pop, fused dispatch, request completion) — each
# caller checks ACTIVE first, so these run only while profiling
def record_queue_wait(name: str, wait_s: float, depth: int) -> None:
    default_profiler.observe("queue_wait", name, wait_s, depth=depth)


def record_fused(name: str, host_s: float,
                 device_s: Optional[float] = None) -> None:
    default_profiler.observe("fused", name, host_s)
    if device_s is not None:
        default_profiler.observe("fused_device", name, device_s)


def record_request(series: str, seconds: float, ok: bool = True) -> None:
    default_profiler.record_request(series, seconds, ok=ok)


# -- profile artifacts -------------------------------------------------------

SCHEMA_VERSION = 1
# duration scopes that belong to a pipeline (name-prefixed) and persist
# into artifacts; request/serving series are deployment-shaped, not
# topology-shaped, and stay out
_ARTIFACT_SCOPES = ("element", "fused", "fused_device", "queue_wait")


def topology_hash(pipeline) -> str:
    """Stable hash of a pipeline's topology: canonical element names
    (positional aliases for auto-named elements — see
    :func:`canonical_base`), element types, and the pad link graph (NOT
    runtime state) — the artifact/AOT-cache key half that survives
    restarts and identifies 'the same graph' across processes and
    replicas parsing the same launch line."""
    canon = {name: canonical_base(el)
             for name, el in pipeline.elements.items()}
    items: List[str] = []
    for name in sorted(pipeline.elements, key=lambda n: canon[n]):
        el = pipeline.elements[name]
        items.append(f"{canon[name]}={el.ELEMENT_NAME}")
        for pad in el.src_pads:
            if pad.peer is not None:
                items.append(f"{canon[name]}.{pad.name}->"
                             f"{canon[pad.peer.element.name]}."
                             f"{pad.peer.name}")
    return hashlib.sha256("\n".join(items).encode()).hexdigest()[:16]


def _negotiated_caps(pipeline) -> str:
    for sink in pipeline.sinks:
        for pad in sink.sink_pads:
            if pad.caps is not None:
                return str(pad.caps)
    return ""


class ProfileArtifact:
    """A persisted profile: per-entry digests keyed by
    (topology hash, caps, model version). ``load``/``merge``/``diff``
    are the APIs the placement planner and AOT cache consume — replicas
    of the same topology merge exactly (digest merge is lossless).

    The ``memory`` section (:mod:`.memory`) carries per-stage
    static byte estimates under the SAME stage keys the duration scopes
    use; its merge semantics are **max-watermark** per field — a
    footprint is a high-water mark, so merged replicas report the worst
    observed footprint, never a sum.

    The ``quality`` section (:mod:`.quality`) carries per-edge
    tensor-health cells (NaN/Inf/zero counts, moments, a log-bucket
    value sketch) under the same keys; its merge is **additive** with
    exact histogram merge — a health sketch is a sample population.
    Artifacts with a quality section are the baselines
    ``quality.set_baseline`` scores live drift against."""

    def __init__(self, key: dict, entries: Dict[str, Dict[str, dict]],
                 pipeline: str = "", created: Optional[float] = None,
                 memory: Optional[Dict[str, dict]] = None,
                 quality: Optional[Dict[str, dict]] = None,
                 kernels: Optional[Dict[str, int]] = None):
        self.key = {"topology": str(key.get("topology", "")),
                    "caps": str(key.get("caps", "")),
                    "model_version": str(key.get("model_version", ""))}
        # entries: {scope: {name: {"count": int, "total_s": float,
        #                          "digest": QuantileDigest}}}
        self.entries = entries
        # memory: {stage: {"kind": str, <byte fields>, "total_bytes": int}}
        self.memory: Dict[str, dict] = dict(memory or {})
        # quality: {stage: TensorHealth cell — obs/quality.py to_cell()}
        self.quality: Dict[str, dict] = dict(quality or {})
        # kernels: {hand kernel: launches while the profiler was on}
        self.kernels: Dict[str, int] = dict(kernels or {})
        self.pipeline = pipeline
        self.created = time.time() if created is None else created

    # -- construction --------------------------------------------------------
    @classmethod
    def capture(cls, pipeline, caps: Optional[str] = None,
                model_version: str = "",
                profiler: Optional[Profiler] = None) -> "ProfileArtifact":
        """Extract ``pipeline``'s series from the (default) profiler,
        stripping the pipeline-name prefix so artifacts captured on
        different replicas of the same topology merge by entry name."""
        p = profiler if profiler is not None else default_profiler
        prefix = f"{pipeline.name}:"
        entries: Dict[str, Dict[str, dict]] = {}
        # digests are copied UNDER the profiler lock — a concurrent
        # observe() inserting a bucket must not race the copy's iteration
        with p._lock:
            for (scope, name), s in p._durations.items():
                if (scope not in _ARTIFACT_SCOPES
                        or not name.startswith(prefix)):
                    continue
                entries.setdefault(scope, {})[name[len(prefix):]] = {
                    "count": s.count,
                    "total_s": s.total_s,
                    "digest": s.digest.copy(),
                }
        # byte estimates ride the same key: the memory accountant names
        # stages exactly like the profiler series, so the prefix strip
        # lines fused/filter footprints up with the duration entries
        from . import memory as obs_memory

        mem = {name[len(prefix):]: cell
               for name, cell in obs_memory.accountant()
               .stages(prefix).items()}
        # tensor-health cells ride the same key + prefix strip, so a
        # captured artifact doubles as a drift baseline
        from . import quality as obs_quality

        qual = {name[len(prefix):]: cell
                for name, cell in obs_quality.accountant()
                .stages(prefix).items()}
        kernels = {}
        if profiler is None and _kernels_at_start:
            kernels = {k: n - _kernels_at_start.get(k, 0)
                       for k, n in kernel_launches().items()
                       if n > _kernels_at_start.get(k, 0)}
        return cls(
            {"topology": topology_hash(pipeline),
             "caps": _negotiated_caps(pipeline) if caps is None else caps,
             "model_version": model_version},
            entries, pipeline=pipeline.name, memory=mem, quality=qual,
            kernels=kernels)

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> dict:
        d = {
            "schema": SCHEMA_VERSION,
            "kind": "nns-profile",
            "created": self.created,
            "pipeline": self.pipeline,
            "key": dict(self.key),
            "entries": {
                scope: {name: {"count": e["count"],
                               "total_s": e["total_s"],
                               "digest": e["digest"].to_dict()}
                        for name, e in sorted(names.items())}
                for scope, names in sorted(self.entries.items())
            },
            "memory": {name: dict(cell)
                       for name, cell in sorted(self.memory.items())},
            "quality": {name: dict(cell)
                        for name, cell in sorted(self.quality.items())},
        }
        if self.kernels:
            d["kernels"] = dict(sorted(self.kernels.items()))
        return d

    def save(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2)
        return path

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileArtifact":
        if d.get("kind") != "nns-profile":
            raise ValueError("not a profile artifact (kind != nns-profile)")
        if int(d.get("schema", 0)) > SCHEMA_VERSION:
            raise ValueError(
                f"artifact schema {d['schema']} is newer than supported "
                f"{SCHEMA_VERSION}")
        entries = {
            scope: {name: {"count": int(e["count"]),
                           "total_s": float(e["total_s"]),
                           "digest": QuantileDigest.from_dict(e["digest"])}
                    for name, e in names.items()}
            for scope, names in d.get("entries", {}).items()
        }
        return cls(d["key"], entries, pipeline=d.get("pipeline", ""),
                   created=d.get("created"),
                   memory={str(n): dict(c)
                           for n, c in (d.get("memory") or {}).items()},
                   quality={str(n): dict(c)
                            for n, c in (d.get("quality") or {}).items()},
                   kernels={str(k): int(n)
                            for k, n in (d.get("kernels") or {}).items()})

    @classmethod
    def load(cls, path: str) -> "ProfileArtifact":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    # -- algebra -------------------------------------------------------------
    def merge(self, other: "ProfileArtifact") -> "ProfileArtifact":
        """Fold another run/replica of the SAME key into this artifact
        (in place; returns self). Digest merge is exact, so merged
        replica profiles equal the pooled-sample profile."""
        if other.key != self.key:
            raise ValueError(
                f"cannot merge artifacts with different keys: "
                f"{self.key} != {other.key}")
        for scope, names in other.entries.items():
            mine = self.entries.setdefault(scope, {})
            for name, e in names.items():
                cell = mine.get(name)
                if cell is None:
                    mine[name] = {"count": e["count"],
                                  "total_s": e["total_s"],
                                  "digest": e["digest"].copy()}
                else:
                    cell["count"] += e["count"]
                    cell["total_s"] += e["total_s"]
                    cell["digest"].merge(e["digest"])
        # memory is max-watermark per field: two replicas' footprints
        # merge to the worst observed, never a sum. total_bytes is then
        # RECOMPUTED from the merged field maxes — maxing it
        # independently would understate a cell whose replicas peaked on
        # different fields (and the planner reads total_bytes)
        from . import memory as obs_memory

        for name, cell in other.memory.items():
            mine = self.memory.get(name)
            if mine is None:
                self.memory[name] = dict(cell)
                continue
            for field, value in cell.items():
                if field == "kind":
                    mine.setdefault("kind", value)
                elif isinstance(value, (int, float)):
                    if value > mine.get(field, 0):
                        mine[field] = value
            if any(f in mine for f in obs_memory.FIELDS):
                mine["total_bytes"] = sum(int(mine.get(f, 0) or 0)
                                          for f in obs_memory.FIELDS)
        # quality is additive: counts sum and the value sketches merge
        # exactly (obs/quality.py merge_cells) — two replicas' health
        # cells pool into the health of the pooled samples
        from . import quality as obs_quality

        for name, cell in other.quality.items():
            mine = self.quality.get(name)
            if mine is None:
                self.quality[name] = dict(cell)
            else:
                obs_quality.merge_cells(mine, cell)
        # kernel launches are additive, as the samples they came with
        for name, n in other.kernels.items():
            self.kernels[name] = self.kernels.get(name, 0) + n
        self.created = max(self.created, other.created)
        return self

    def diff(self, other: "ProfileArtifact") -> dict:
        """Per-entry p50/p99 deltas (other - self), for regression hunts
        across model versions / code changes. Keys need not match —
        entries are compared by (scope, name); one-sided entries report
        the side they exist on."""
        out: Dict[str, dict] = {}
        scopes = set(self.entries) | set(other.entries)
        for scope in sorted(scopes):
            a_names = self.entries.get(scope, {})
            b_names = other.entries.get(scope, {})
            for name in sorted(set(a_names) | set(b_names)):
                a, b = a_names.get(name), b_names.get(name)
                row: dict = {"scope": scope}
                if a is not None:
                    row["a"] = {"count": a["count"],
                                "p50_ms": a["digest"].quantile(0.5) * 1e3,
                                "p99_ms": a["digest"].quantile(0.99) * 1e3}
                if b is not None:
                    row["b"] = {"count": b["count"],
                                "p50_ms": b["digest"].quantile(0.5) * 1e3,
                                "p99_ms": b["digest"].quantile(0.99) * 1e3}
                if a is not None and b is not None:
                    row["delta_p50_ms"] = (row["b"]["p50_ms"]
                                           - row["a"]["p50_ms"])
                    row["delta_p99_ms"] = (row["b"]["p99_ms"]
                                           - row["a"]["p99_ms"])
                out.setdefault(scope, {})[name] = row
        return out

    def summary(self) -> dict:
        """{scope: {name: {count, p50_ms, p99_ms, total_s}}} — the
        human/bench-facing attribution table (plus the ``memory``
        byte-estimate section when captured)."""
        out = {
            scope: {name: {"count": e["count"],
                           "total_s": round(e["total_s"], 6),
                           "p50_ms": round(e["digest"].quantile(0.5) * 1e3, 4),
                           "p99_ms": round(e["digest"].quantile(0.99) * 1e3,
                                           4)}
                    for name, e in sorted(names.items())}
            for scope, names in sorted(self.entries.items())
        }
        if self.memory:
            out["memory"] = {name: dict(cell)
                             for name, cell in sorted(self.memory.items())}
        if self.quality:
            out["quality"] = {
                name: {"buffers": cell.get("buffers", 0),
                       "elems": cell.get("elems", 0),
                       "nan": cell.get("nan", 0),
                       "inf": cell.get("inf", 0)}
                for name, cell in sorted(self.quality.items())}
        if self.kernels:
            out["kernels"] = dict(sorted(self.kernels.items()))
        return out


#: env var naming the default on-disk ProfileStore directory — the
#: placement planner (runtime/placement.py) and the NNL014 lint hint
#: consult it when no explicit store is handed in; unset = no default
#: store (plan falls back to calibration/heuristics)
STORE_ENV = "NNS_PROFILE_STORE"

#: env var bounding the default store's artifact count (LRU prune on
#: save); unset/0 = unbounded, the pre-PR-10 behavior
STORE_MAX_ENV = "NNS_PROFILE_STORE_MAX"


def default_store() -> Optional["ProfileStore"]:
    """The process-default artifact store (``NNS_PROFILE_STORE`` dir), or
    None when the env var is unset. The directory is created on first
    use (ProfileStore.__init__)."""
    root = os.environ.get(STORE_ENV, "").strip()
    if not root:
        return None
    raw_max = os.environ.get(STORE_MAX_ENV, "").strip()
    try:
        max_artifacts = int(raw_max) if raw_max else None
    except ValueError:
        max_artifacts = None
    return ProfileStore(root, max_artifacts=max_artifacts)


class ProfileStore:
    """On-disk artifact store keyed by (topology, caps, model version).
    ``save(merge=True)`` folds a new capture into the existing artifact
    for the same key, so profiles accumulate across restarts — the
    persistence the placement planner reads at plan time.

    ``max_artifacts`` bounds the store: without it one artifact per
    (topology, caps, model version) accumulates FOREVER across restarts
    — every experiment's one-off launch line leaves a file. When set,
    ``save()`` LRU-prunes (oldest mtime first) down to the bound, and
    the just-saved key always survives (its mtime is newest).
    :meth:`prune` prunes on demand."""

    def __init__(self, root: str, max_artifacts: Optional[int] = None):
        self.root = root
        self.max_artifacts = max_artifacts
        os.makedirs(root, exist_ok=True)

    @staticmethod
    def _ctx_hash(key: dict) -> str:
        return hashlib.sha256(
            (key.get("caps", "") + "\n" + key.get("model_version", ""))
            .encode()).hexdigest()[:8]

    def path_for(self, key: dict) -> str:
        return os.path.join(
            self.root,
            f"profile-{key.get('topology', 'unknown')}-"
            f"{self._ctx_hash(key)}.json")

    def save(self, artifact: ProfileArtifact, merge: bool = True) -> str:
        path = self.path_for(artifact.key)
        if merge and os.path.exists(path):
            existing = ProfileArtifact.load(path)
            if existing.key == artifact.key:
                artifact = existing.merge(artifact)
        out = artifact.save(path)
        if self.max_artifacts:
            self.prune(self.max_artifacts)
        return out

    def _artifact_paths(self) -> List[str]:
        return [os.path.join(self.root, f)
                for f in sorted(os.listdir(self.root))
                if f.startswith("profile-") and f.endswith(".json")]

    def prune(self, max_artifacts: Optional[int] = None) -> List[str]:
        """LRU-evict artifacts beyond the bound (oldest mtime first —
        ``save()`` rewrites its key's file, so actively-merged keys stay
        newest and cold one-off keys age out). Returns removed paths."""
        bound = max_artifacts if max_artifacts is not None \
            else self.max_artifacts
        if not bound or bound < 1:
            return []
        paths = self._artifact_paths()
        if len(paths) <= bound:
            return []

        def mtime(p: str) -> float:
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0
        victims = sorted(paths, key=lambda p: (mtime(p), p))[:-bound]
        removed = []
        for p in victims:
            try:
                os.remove(p)
                removed.append(p)
            except OSError:
                continue
        return removed

    def load(self, key: dict) -> Optional[ProfileArtifact]:
        path = self.path_for(key)
        if not os.path.exists(path):
            return None
        return ProfileArtifact.load(path)

    def list(self) -> List[dict]:
        out = []
        for fname in sorted(os.listdir(self.root)):
            if fname.startswith("profile-") and fname.endswith(".json"):
                try:
                    art = ProfileArtifact.load(
                        os.path.join(self.root, fname))
                except (OSError, ValueError, KeyError):
                    continue
                out.append({"path": os.path.join(self.root, fname),
                            **art.key})
        return out


# -- text dashboard (obs top) -------------------------------------------------

def render_top(profile_snap: dict, slo_status: List[dict],
               placement: Optional[List[dict]] = None,
               memory: Optional[dict] = None,
               quality: Optional[dict] = None,
               autoscale: Optional[List[dict]] = None,
               fleet: Optional[List[dict]] = None,
               transport: Optional[dict] = None,
               aot: Optional[dict] = None) -> str:
    """The ``obs top`` one-shot/watch dashboard: per-element rates,
    queue waits + depths, fused quantiles, request series, SLO burn,
    a MEMORY section (device watermarks, stage byte estimates, queue
    occupancy — :mod:`.memory`) when a memory snapshot is supplied,
    a QUALITY section (per-edge tensor health + drift — :mod:`.quality`)
    when a quality snapshot is supplied, a FLEET section
    (``obs/fleet.py``) and an AUTOSCALER section (replica counts, last
    decision inputs — ``service/autoscaler.py``) when their snapshots
    are supplied, and — when a placement plan or a transport snapshot is
    supplied — per-stage device assignment + balance
    (``runtime.placement.snapshot_all()``) and the wire formats, and an
    AOT COMPILE CACHE section (``aot.snapshot()``) when the cache is on
    or counted anything."""
    lines = [f"nns obs top — profiling "
             f"{'ON' if profile_snap.get('active') else 'off'}"]
    if fleet:
        from . import fleet as obs_fleet

        lines.extend(obs_fleet.render_section(fleet))
    for a in autoscale or []:
        last = a.get("last_decision") or {}
        lines.append("")
        lines.append(
            f"AUTOSCALER [{a.get('name', '?')}] replicas "
            f"{a.get('replicas', '?')}/{a.get('desired_replicas', '?')} "
            f"(bounds {a.get('min_replicas', '?')}"
            f"-{a.get('max_replicas', '?')}) "
            f"shed={'ARMED' if a.get('shed_armed') else 'off'}")
        lines.append(
            f"  events: out={a.get('scale_out', 0)} "
            f"in={a.get('scale_in', 0)} "
            f"blocked_by_memory={a.get('blocked_by_memory', 0)} "
            f"respawns={a.get('respawns', 0)} "
            f"gave_up={a.get('respawn_gave_up', 0)}")
        if last:
            lines.append(
                f"  last: {last.get('action', '?'):<16} "
                f"burn {last.get('burn_short', 0):.2f}/"
                f"{last.get('burn_long', 0):.2f} "
                f"(n={last.get('samples_short', 0)}) "
                f"mem {last.get('memory_used_fraction', 0):.2f} "
                f"cooldown out {last.get('out_cooldown_s', 0):.1f}s / "
                f"in {last.get('in_cooldown_s', 0):.1f}s")
    if transport and (transport.get("negotiated") or transport.get("shm")):
        # the data plane (transport/stats.py): which wire formats this
        # process's connections negotiated + shm ring traffic/fallbacks
        lines.append("")
        conns = transport.get("connections", {})
        neg = transport.get("negotiated", {})
        parts = [f"{fmt}:{neg.get(fmt, 0)}"
                 f"({conns.get(fmt, 0)} open)" for fmt in sorted(neg)]
        lines.append("TRANSPORT negotiated " + (" ".join(parts) or "—"))
        frames = transport.get("frames", {})
        nbytes = transport.get("bytes", {})
        if frames:
            lines.append(f"  {'plane':<14} {'frames':>10} {'MB':>10}")
            for key in sorted(frames):
                lines.append(f"  {key:<14} {frames[key]:>10d} "
                             f"{nbytes.get(key, 0) / 1e6:>10.2f}")
        shm = transport.get("shm", {})
        if shm:
            lines.append(
                f"  shm: writes={shm.get('slot_writes', 0)} "
                f"reclaimed={shm.get('reclaimed_slots', 0)} "
                f"full-fallbacks={shm.get('fallback_full', 0)} "
                f"oversize={shm.get('fallback_oversize', 0)} "
                f"segments={shm.get('segments_created', 0)}c/"
                f"{shm.get('segments_attached', 0)}a/"
                f"{shm.get('segments_closed', 0)}x")
    for plan in placement or []:
        lines.append("")
        lines.append(f"PLACEMENT [{plan.get('pipeline', '?')}] "
                     f"source={plan.get('source', '?')} "
                     f"max-stage {plan.get('balance', {}).get('max_stage_ms', 0):.3f}ms "
                     f"/ target {plan.get('balance', {}).get('target_ms', 0):.3f}ms")
        lines.append(f"  {'stage':<40} {'device':>8} {'cost_ms':>9}")
        for st in plan.get("stages", []):
            lines.append(f"  {st['stage']:<40} {st['device']:>8d} "
                         f"{st['cost_ms']:>9.3f}")
        for qname, q in sorted(plan.get("queues", {}).items()):
            lines.append(f"  queue {qname:<34} depth={q['depth']:<4d} "
                         f"(wait p99 {q.get('wait_p99_ms', 0.0):.3f}ms)")
    durations = profile_snap.get("durations", {})
    sections = (("element", "ELEMENTS (per-hop wall time)"),
                ("fused", "FUSED SEGMENTS (host dispatch)"),
                ("fused_device", "FUSED SEGMENTS (device probe)"),
                ("queue_wait", "QUEUE WAIT"),
                ("serving", "SERVING BATCHES"))
    for scope, title in sections:
        names = durations.get(scope)
        if not names:
            continue
        lines.append("")
        lines.append(f"{title}")
        lines.append(f"  {'name':<40} {'rate/s':>8} {'p50ms':>9} "
                     f"{'p99ms':>9} {'maxms':>9} {'n':>8}"
                     + ("  depth" if scope == "queue_wait" else ""))
        for name, s in names.items():
            row = (f"  {name:<40} {s['rate_hz']:>8.1f} {s['p50_ms']:>9.3f} "
                   f"{s['p99_ms']:>9.3f} {s['max_ms']:>9.3f} "
                   f"{s['count']:>8d}")
            if scope == "queue_wait" and "depth" in s:
                row += f"  {s['depth']:>5d}"
            lines.append(row)
    transfers = profile_snap.get("transfers")
    if transfers:
        # NNS_XFERCHECK byte ledger (analysis/sanitizer.py third half):
        # where bytes cross the host/device and process boundaries,
        # largest movers first
        lines.append("")
        lines.append("TRANSFERS (NNS_XFERCHECK byte ledger)")
        lines.append(f"  {'stage':<40} {'dir':>8} {'MiB':>10} {'n':>8}")
        for row in transfers:
            lines.append(
                f"  {row['stage']:<40} {row['direction']:>8} "
                f"{row['bytes'] / (1 << 20):>10.3f} {row['count']:>8d}")
    requests = profile_snap.get("requests", {})
    if requests:
        lines.append("")
        lines.append("REQUESTS")
        lines.append(f"  {'series':<40} {'p50ms':>9} {'p99ms':>9} "
                     f"{'maxms':>9} {'n':>8} {'err':>6}")
        for name, s in requests.items():
            lines.append(
                f"  {name:<40} {s['p50_ms']:>9.2f} {s['p99_ms']:>9.2f} "
                f"{s['max_ms']:>9.2f} {s['count']:>8d} {s['errors']:>6d}")
    if aot and (aot.get("active") or any(aot.get("counters", {}).values())):
        from .. import aot as aot_plane

        # hit/miss/export/eviction totals + the artifact inventory
        lines.extend(aot_plane.render_section(aot))
    if memory:
        from . import memory as obs_memory

        lines.extend(obs_memory.render_section(memory))
    if quality:
        from . import quality as obs_quality

        lines.extend(obs_quality.render_section(quality))
    if slo_status:
        lines.append("")
        lines.append("SLO (burn = bad-fraction / error budget)")
        lines.append(f"  {'objective':<28} {'target':>7} {'window':>10} "
                     f"{'burn':>8} {'state':>9}")
        for st in slo_status:
            state = "BREACH" if st.get("alerting") else "ok"
            for w in st.get("windows", []):
                lines.append(
                    f"  {st['name']:<28} {st['target']:>7.4f} "
                    f"{w['short_s']:>9.0f}s {w['burn_short']:>8.2f} "
                    f"{state:>9}")
                lines.append(
                    f"  {'':<28} {'':>7} {w['long_s']:>9.0f}s "
                    f"{w['burn_long']:>8.2f} {'':>9}")
    return "\n".join(lines)
