"""Data-plane quality observability: tensor health taps + drift scoring (L7).

The port of nnstreamer_tpu's ``obs/quality.py``: the data-plane twin of
the profiler, built on the same keying and persistence machinery.

* **tensor health taps** — a :class:`~..utils.trace.Tracer` installed by
  :func:`start` rides the existing ``Pad.push`` hook (taps off = the one
  ``trace.ACTIVE`` attribute read every other tracer already pays) and
  samples every ``SAMPLE_EVERY``-th buffer per edge into per-edge
  :class:`TensorHealth` cells: NaN/Inf counts, zero fraction,
  min/max/mean/variance, and a log-bucket value-histogram sketch
  reusing :class:`~.profile.QuantileDigest` (γ = 2: power-of-two
  buckets, so sketches from any tap merge exactly). Cells are keyed by
  the same canonical ``<pipeline>:<stage>`` series names the profiler
  and memory accountant use.

* **device-side reduction** — a tensor that lives where a model ran (a
  CUDA tensor, or a filter's CPU output: the reference's jax arrays) is
  reduced by torch ops on its own device — counts, moments and a
  64-bucket log₂ histogram, the same arithmetic as the reference's
  jitted reduce — and only that small result (73 scalars) is pulled,
  never the tensor. Host numpy arrays take the numpy reduce. A CPU
  ``torch.bfloat16`` tensor is host bfloat16 (core/buffer.py): the
  reference's is an ``ml_dtypes`` array, which its numpy reduce does not
  tap, so neither does the port's.

* **baselines + drift scoring** — ``ProfileArtifact.capture`` persists
  the per-edge cells as a ``quality`` section under the same (topology,
  caps, model-version) key (merge = additive counts + exact histogram
  merge). :func:`set_baseline` loads such an artifact as the reference
  distribution; :func:`score_tick` then scores each edge's *fresh*
  samples (the delta since the previous tick, so recovery is
  observable) against its baseline with a PSI-style metric over the
  merged histograms (:func:`psi`). Fresh NaN/Inf at any edge scores
  :data:`NONFINITE_SCORE` outright, baseline or not.

* **the closed loops** — first NaN/Inf per edge and drift-threshold
  crossings land as ``quality`` flight events; ``nns_quality_*`` gauges
  render through :mod:`.metrics`; a ``quality``-kind
  :class:`~.slo.SLObjective` samples :func:`worst_score` each tick; and
  :class:`CanaryQuality` / :class:`QualityGate` /
  :class:`SpecAcceptanceGate` are the promotion gates the reference's
  service layer calls (the port has no service layer yet, ROADMAP A6).

Cost contract: with taps off every hook is ONE module-global check
(:data:`ACTIVE` on the serving path, ``trace.ACTIVE`` on the pad path);
sampling cost is one small reduction every ``SAMPLE_EVERY`` buffers per
edge. Taps only *read* tensors — byte parity of a sampled pipeline vs
taps-off is exact.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import sanitizer as _san
from ..analysis.sanitizer import named_lock
from ..utils.log import logger
from . import flight as obs_flight
from . import metrics as obs_metrics
from .profile import QuantileDigest

# module-global fast path: the fused-dispatch / serving hooks check this
# and only this when the taps are off (the microbench gate measures it);
# the pad tap additionally hides behind trace.ACTIVE (tracer install)
ACTIVE = False

#: sample cadence: one health reduction every N buffers per edge
#: (``start(sample_every=...)`` overrides)
SAMPLE_EVERY = 8

#: drift score assigned when fresh samples contain NaN/Inf the baseline
#: did not — numerically broken beats any distribution argument
NONFINITE_SCORE = 10.0

#: fewer fresh finite samples than this score 0.0 (PSI over a handful of
#: values is noise, not drift)
MIN_SCORE_SAMPLES = 32

# the histogram sketch: QuantileDigest with alpha = 1/3 gives
# γ = (1+α)/(1−α) = 2 exactly — bucket i covers (2^(i−1), 2^i], so the
# host (numpy) and device (torch) reducers compute IDENTICAL bucket
# indices with plain ceil(log2(|v|)), and merge stays exact
HIST_ALPHA = 1.0 / 3.0
HIST_LO, HIST_HI = -32, 32          # clamped index range: 2^-32 .. 2^31
N_BUCKETS = HIST_HI - HIST_LO
MIN_VALUE = QuantileDigest.MIN_VALUE  # |v| at or below → zero bucket


# ---------------------------------------------------------------------------
# reducers: one tensor -> (elems, int counts, float moments, histogram)
# ---------------------------------------------------------------------------
# both paths return the same shape:
#   ivec = [nan, inf, zero, zeroish, n_finite]   (zeroish: 0 < |v| <= MIN
#          collapses into the sketch's zero bucket alongside exact zeros)
#   fvec = [finite_sum, finite_sumsq, finite_min, finite_max]
#   counts = int[N_BUCKETS] of finite |v| > MIN, index ceil(log2|v|)-LO

def _reduce_np(t) -> Optional[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    a = np.asarray(t)
    if a.dtype.kind in "iub":
        a = a.astype(np.float32)
    elif a.dtype.kind != "f":
        return None  # non-numeric payloads (strings) are not tapped
    nan = int(np.isnan(a).sum())
    inf = int(np.isinf(a).sum())
    vals = a[np.isfinite(a)]
    absv = np.abs(vals)
    zero = int((vals == 0).sum())
    zeroish = int((absv <= MIN_VALUE).sum())
    live = absv[absv > MIN_VALUE]
    if live.size:
        idx = np.clip(np.ceil(np.log2(live)), HIST_LO,
                      HIST_HI - 1).astype(np.int64)
        counts = np.bincount(idx - HIST_LO, minlength=N_BUCKETS)
    else:
        counts = np.zeros(N_BUCKETS, np.int64)
    v64 = vals.astype(np.float64, copy=False)
    fvec = np.array([v64.sum(), (v64 * v64).sum(),
                     v64.min() if vals.size else 0.0,
                     v64.max() if vals.size else 0.0], np.float64)
    ivec = np.array([nan, inf, zero, zeroish, vals.size], np.int64)
    return a.size, ivec, fvec, counts


def _log2(x):
    """log2 as the bucket index sees it. ``jnp.log2`` is ``log(x) /
    log(2)`` in the input's dtype; in bfloat16 and float16 that
    quotient's rounding decides the bucket, so the port computes the
    same quotient (every bfloat16 bucket then equals the reference's).
    In float32 and wider it is ``torch.log2``, whose buckets equal the
    reference's host reduce (``np.log2``) on every value; XLA's float32
    quotient misbuckets some values within two ulps of a power of two
    (2^-13 and 2^-15 exactly, among others)."""
    if x.element_size() < 4:
        return torch.log(x) / torch.log(torch.full((), 2.0, dtype=x.dtype,
                                                   device=x.device))
    return torch.log2(x)


def _torch_reduce(x):
    """The device-side reduce (reference ``_device_reduce``, a ``jax.jit``
    of jnp ops): the same arithmetic in torch ops on ``x``'s own device,
    in ``x``'s own dtype where the reference keeps it (a bfloat16 tensor
    is summed, squared and bucketed in bfloat16). Returns one float64
    vector ``[ivec(5), fvec(4), counts(N_BUCKETS)]`` still on the
    device."""
    xf = x if x.is_floating_point() else x.to(torch.float32)
    nan = torch.isnan(xf).sum()
    inf = torch.isinf(xf).sum()
    finite = torch.isfinite(xf)
    nfin = finite.sum()
    zero_t = torch.zeros((), dtype=xf.dtype, device=xf.device)
    vals = torch.where(finite, xf, zero_t)
    absv = vals.abs()
    zero = (finite & (xf == 0)).sum()
    zeroish = (finite & (absv <= MIN_VALUE)).sum()
    live = finite & (absv > MIN_VALUE)
    idx = torch.clamp(torch.ceil(_log2(torch.where(live, absv, zero_t + 1))),
                      HIST_LO, HIST_HI - 1).to(torch.int64)
    counts = torch.zeros(N_BUCKETS, dtype=torch.int64,
                         device=xf.device).index_add_(
        0, idx.reshape(-1) - HIST_LO, live.reshape(-1).to(torch.int64))
    if xf.numel():
        pos_inf = torch.full((), math.inf, dtype=xf.dtype, device=xf.device)
        fmin = torch.where(nfin > 0, torch.where(finite, xf, pos_inf).amin(),
                           zero_t)
        fmax = torch.where(nfin > 0, torch.where(finite, xf, -pos_inf).amax(),
                           zero_t)
    else:
        fmin = fmax = zero_t
    ivec = torch.stack([nan, inf, zero, zeroish, nfin])
    fvec = torch.stack([vals.sum(), (vals * vals).sum(),
                        fmin, fmax]).to(torch.float32)
    return torch.cat([ivec.to(torch.float64), fvec.to(torch.float64),
                      counts.to(torch.float64)])


#: bytes one device reduce pulls to the host (73 float64 scalars)
REDUCE_PULL_BYTES = (5 + 4 + N_BUCKETS) * 8


def _reduce_any(t) -> Optional[Tuple[int, np.ndarray, np.ndarray,
                                     np.ndarray]]:
    """Host path for numpy tensors, device path for torch tensors — a
    host tap on a device-resident tensor pulls 73 scalars, never the
    tensor. A CPU ``torch.bfloat16`` tensor is host bfloat16 and is not
    tapped (the reference's host bfloat16 is an ``ml_dtypes`` array,
    which ``_reduce_np`` skips as non-numeric)."""
    if isinstance(t, np.ndarray):
        return _reduce_np(t)
    if not isinstance(t, torch.Tensor):
        return None
    if t.device.type == "cpu" and t.dtype is torch.bfloat16:
        return None
    if t.is_complex():
        return None
    packed = _torch_reduce(t.detach())
    if _san.XFER and t.device.type != "cpu":
        _san.note_transfer("quality:reduce", "d2h", REDUCE_PULL_BYTES)
    # nnlint: disable=NNL101 — sampled health probe: pulls the packed
    # reduction (REDUCE_PULL_BYTES) every SAMPLE_EVERY buffers, by contract
    host = packed.cpu().numpy()
    size = 1
    for d in t.shape:
        size *= int(d)
    return (size, host[:5].astype(np.int64), host[5:9],
            host[9:].astype(np.int64))


# ---------------------------------------------------------------------------
# the per-edge health cell
# ---------------------------------------------------------------------------

class TensorHealth:
    """Running numerical-health aggregate of one tapped edge: counts,
    moments, extremes, and a power-of-two log-bucket sketch of |value|
    (:class:`QuantileDigest` with γ = 2 — merge is exact, see
    :func:`psi`). All counters are additive, so cells merge across
    replicas/runs by plain addition + digest merge."""

    __slots__ = ("buffers", "elems", "nan", "inf", "zero", "sum", "sumsq",
                 "finite", "min", "max", "hist")

    def __init__(self):
        self.buffers = 0
        self.elems = 0
        self.nan = 0
        self.inf = 0
        self.zero = 0
        self.finite = 0
        self.sum = 0.0
        self.sumsq = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.hist = QuantileDigest(HIST_ALPHA)

    def fold(self, elems: int, ivec, fvec, counts) -> None:
        self.elems += int(elems)
        self.nan += int(ivec[0])
        self.inf += int(ivec[1])
        self.zero += int(ivec[2])
        nfin = int(ivec[4])
        self.finite += nfin
        self.sum += float(fvec[0])
        self.sumsq += float(fvec[1])
        if nfin:
            self.min = min(self.min, float(fvec[2]))
            self.max = max(self.max, float(fvec[3]))
        h = self.hist
        zeroish = int(ivec[3])
        h._zero += zeroish
        h.count += zeroish
        if zeroish:
            h.min = 0.0
        b = h._buckets
        for i in range(N_BUCKETS):
            c = int(counts[i])
            if c:
                k = HIST_LO + i
                b[k] = b.get(k, 0) + c
                h.count += c
                # bucket-derived |v| bounds: enough for quantile()'s
                # clamp at this sketch's factor-2 resolution
                h.min = min(h.min, 2.0 ** (k - 1))
                h.max = max(h.max, 2.0 ** k)

    # -- derived -------------------------------------------------------------
    @property
    def nan_frac(self) -> float:
        return self.nan / self.elems if self.elems else 0.0

    @property
    def inf_frac(self) -> float:
        return self.inf / self.elems if self.elems else 0.0

    @property
    def zero_frac(self) -> float:
        return self.zero / self.elems if self.elems else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.finite if self.finite else 0.0

    @property
    def variance(self) -> float:
        if not self.finite:
            return 0.0
        m = self.mean
        return max(0.0, self.sumsq / self.finite - m * m)

    def snapshot(self) -> dict:
        return {
            "buffers": self.buffers, "elems": self.elems,
            "nan": self.nan, "inf": self.inf,
            "nan_frac": self.nan_frac, "inf_frac": self.inf_frac,
            "zero_frac": round(self.zero_frac, 6),
            "min": None if not self.finite else self.min,
            "max": None if not self.finite else self.max,
            "mean": self.mean, "variance": self.variance,
        }

    # -- persistence (the artifact `quality` section cell) -------------------
    def to_cell(self, kind: str = "edge") -> dict:
        return {
            "kind": kind, "buffers": self.buffers, "elems": self.elems,
            "nan": self.nan, "inf": self.inf, "zero": self.zero,
            "finite": self.finite, "sum": self.sum, "sumsq": self.sumsq,
            "min": None if not self.finite else self.min,
            "max": None if not self.finite else self.max,
            "hist": self.hist.to_dict(),
        }

    @classmethod
    def from_cell(cls, cell: dict) -> "TensorHealth":
        h = cls()
        h.buffers = int(cell.get("buffers", 0))
        h.elems = int(cell.get("elems", 0))
        h.nan = int(cell.get("nan", 0))
        h.inf = int(cell.get("inf", 0))
        h.zero = int(cell.get("zero", 0))
        h.finite = int(cell.get("finite", 0))
        h.sum = float(cell.get("sum", 0.0))
        h.sumsq = float(cell.get("sumsq", 0.0))
        if cell.get("min") is not None:
            h.min = float(cell["min"])
        if cell.get("max") is not None:
            h.max = float(cell["max"])
        if cell.get("hist"):
            h.hist = QuantileDigest.from_dict(cell["hist"])
        return h


def merge_cells(mine: dict, other: dict) -> dict:
    """Fold another run's serialized quality cell into ``mine`` (in
    place; returns it). Counts add, extremes extend, histograms merge
    exactly — the semantics ``ProfileArtifact.merge`` applies to the
    ``quality`` section (additive, unlike memory's max-watermark: a
    health sketch is a sample population, not a high-water mark)."""
    for f in ("buffers", "elems", "nan", "inf", "zero", "finite"):
        mine[f] = int(mine.get(f, 0)) + int(other.get(f, 0))
    for f in ("sum", "sumsq"):
        mine[f] = float(mine.get(f, 0.0)) + float(other.get(f, 0.0))
    for f, pick in (("min", min), ("max", max)):
        a, b = mine.get(f), other.get(f)
        mine[f] = pick(a, b) if a is not None and b is not None \
            else (a if a is not None else b)
    mine.setdefault("kind", other.get("kind", "edge"))
    a_hist, b_hist = mine.get("hist"), other.get("hist")
    if a_hist and b_hist:
        merged = QuantileDigest.from_dict(a_hist)
        merged.merge(QuantileDigest.from_dict(b_hist))
        mine["hist"] = merged.to_dict()
    elif b_hist:
        mine["hist"] = dict(b_hist)
    return mine


# ---------------------------------------------------------------------------
# PSI drift metric
# ---------------------------------------------------------------------------

def psi(a: QuantileDigest, b: QuantileDigest, epsilon: float = 1e-4
        ) -> float:
    """Population-stability-index between two value sketches: both are
    normalized over the union of their (shared-γ) buckets plus the zero
    bucket, empty cells smoothed to ``epsilon``, and
    ``Σ (p−q)·ln(p/q)`` summed. 0 = identical distributions; the usual
    operating bands apply (< 0.1 stable, 0.1–0.25 drifting, > 0.25
    shifted). Either sketch empty → 0.0 (nothing to compare)."""
    na, nb = a.count, b.count
    if na == 0 or nb == 0:
        return 0.0
    keys = set(a._buckets) | set(b._buckets)
    score = 0.0
    pairs = [(a._zero / na, b._zero / nb)]
    pairs += [(a._buckets.get(k, 0) / na, b._buckets.get(k, 0) / nb)
              for k in keys]
    for p, q in pairs:
        p = max(p, epsilon)
        q = max(q, epsilon)
        score += (p - q) * math.log(p / q)
    return score


# ---------------------------------------------------------------------------
# the accountant
# ---------------------------------------------------------------------------

class QualityAccountant:
    """Process-wide tensor-health store, keyed like the profiler's
    duration series (``<pipeline>:<canonical-stage>`` for pad taps and
    fused segments, ``serving:<scheduler>`` for batch outputs). The
    first NaN/Inf observed on an edge records a ``quality`` flight
    event (once per edge until :meth:`reset`)."""

    def __init__(self):
        self._lock = named_lock("QualityAccountant._lock")
        self._edges: Dict[str, Tuple[str, TensorHealth]] = {}  # guarded-by: _lock
        self._nonfinite_seen: set = set()                      # guarded-by: _lock

    def observe(self, name: str, tensors, kind: str = "edge") -> None:
        """Fold one sampled buffer's tensors into the edge's cell (host
        reduce for numpy tensors, device reduce for torch tensors)."""
        reduced = []
        for t in tensors:
            r = _reduce_any(t)
            if r is not None:
                reduced.append(r)
        if not reduced:
            return
        self._fold(name, kind, reduced)

    def observe_reduced(self, name: str, kind: str, reduced) -> None:
        self._fold(name, kind, reduced)

    def _fold(self, name: str, kind: str, reduced) -> None:
        fire = None
        with self._lock:
            entry = self._edges.get(name)
            if entry is None:
                entry = self._edges[name] = (kind, TensorHealth())
            cell = entry[1]
            had_nonfinite = cell.nan + cell.inf > 0
            cell.buffers += 1
            for elems, ivec, fvec, counts in reduced:
                cell.fold(elems, ivec, fvec, counts)
            if (not had_nonfinite and cell.nan + cell.inf > 0
                    and name not in self._nonfinite_seen):
                self._nonfinite_seen.add(name)
                fire = {"stage": name, "nan": cell.nan, "inf": cell.inf}
        if fire is not None:
            pipe = name.split(":", 1)[0] if ":" in name else None
            obs_flight.record("quality", "nonfinite", fire, pipeline=pipe)

    # -- reading -------------------------------------------------------------
    def health(self, name: str) -> Optional[TensorHealth]:
        with self._lock:
            entry = self._edges.get(name)
            return entry[1] if entry is not None else None

    def stages(self, prefix: str = "") -> Dict[str, dict]:
        """Serialized cells (the artifact ``quality`` section shape),
        optionally restricted to one pipeline's prefix — rendered under
        the lock so a concurrent fold cannot race the digest copy."""
        with self._lock:
            return {name: entry[1].to_cell(entry[0])
                    for name, entry in self._edges.items()
                    if name.startswith(prefix)}

    def snapshots(self) -> Dict[str, dict]:
        with self._lock:
            return {name: {"kind": entry[0], **entry[1].snapshot()}
                    for name, entry in sorted(self._edges.items())}

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._nonfinite_seen.clear()


default_accountant = QualityAccountant()


def export_state() -> dict:
    """Raw serialized health cells for cross-process aggregation (the
    ``GET /quality?raw=1`` route the fleet scraper reads): the same
    ``to_cell`` shape the artifact ``quality`` section persists, so the
    fleet merge reuses :func:`merge_cells` — additive counts + exact
    histogram merge, a replica fleet's pooled sample population."""
    return {"cells": default_accountant.stages()}


def accountant() -> QualityAccountant:
    return default_accountant


# -- hot call sites (each caller checks ACTIVE / samples first) ---------------

_reduce_failed: set = set()


def record_fused_outputs(name: str, outputs) -> None:
    """Sampled fused-segment output health (``FusedSegment.dispatch``,
    runtime/fusion.py): one device reduce per output tensor. Must never kill
    the dispatch — failures are logged once per segment."""
    try:
        default_accountant.observe(name, outputs, kind="fused")
    except Exception:  # noqa: BLE001 - a tap must never kill dataflow
        if name not in _reduce_failed:
            _reduce_failed.add(name)
            logger.exception("quality tap: fused reduce failed for %s",
                             name)


_serving_n: Dict[str, int] = {}


def observe_outputs(name: str, outputs, kind: str = "serving") -> None:
    """Sampled output tap for the serving schedulers (one call per
    executed batch while the taps are on)."""
    n = _serving_n.get(name, 0)
    _serving_n[name] = n + 1
    if n % SAMPLE_EVERY:
        return
    try:
        default_accountant.observe(name, outputs, kind=kind)
    except Exception:  # noqa: BLE001 - a tap must never kill serving
        if name not in _reduce_failed:
            _reduce_failed.add(name)
            logger.exception("quality tap: serving reduce failed for %s",
                             name)


class _QualityTracer:
    """The pad-hop tap: rides the ``utils.trace`` hook the chrometrace
    and profiler tracers already use, so taps-off cost is exactly the
    one ``trace.ACTIVE`` check ``Pad.push`` always pays. Samples every
    ``SAMPLE_EVERY``-th buffer per edge (per-edge counter cached on the
    element, like the profiler's series-name cache)."""

    NAME = "quality"

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        peer = pad.peer
        if peer is None:
            return
        el = peer.element
        n = el.__dict__.get("_quality_n", 0)
        el.__dict__["_quality_n"] = n + 1
        if n % SAMPLE_EVERY:
            return
        from .profile import series_name

        try:
            default_accountant.observe(series_name(el), buf.tensors)
        except Exception:  # noqa: BLE001 - a tap must never kill dataflow
            name = getattr(el, "name", "?")
            if name not in _reduce_failed:
                _reduce_failed.add(name)
                logger.exception("quality tap: edge reduce failed at %s",
                                 name)

    def results(self) -> dict:
        return default_accountant.snapshots()


# ---------------------------------------------------------------------------
# baselines + drift scoring
# ---------------------------------------------------------------------------

_base_lock = threading.Lock()
_baseline: Dict[str, TensorHealth] = {}       # guarded-by: _base_lock
_drift_threshold = 0.25                       # guarded-by: _base_lock
# per-CONSUMER, per-stage last-seen counters: score_tick() scores the
# DELTA since that consumer's previous tick, so a stage that stops
# emitting bad values cools down and SLO recovery is observable — and
# two concurrent consumers (e.g. two quality SLObjectives on one
# engine) each own a window instead of starving each other
_last_seen: Dict[str, Dict[str, dict]] = {}   # guarded-by: _base_lock
_scores: Dict[str, float] = {}                # guarded-by: _base_lock
_drift_alerting: set = set()  # (consumer, stage)  guarded-by: _base_lock


def set_baseline(source, drift_threshold: float = 0.25) -> None:
    """Install per-edge reference distributions. ``source`` is a
    ``ProfileArtifact`` (its ``quality`` section; stage names are
    pipeline-prefix-stripped, as captured) or a plain
    ``{stage: cell}`` mapping. ``drift_threshold`` is where
    :func:`score_tick` records ``quality`` drift flight events.
    Consumers' fresh-sample windows are PRESERVED: installing a
    baseline mid-life must not re-score history already ticked past
    (NaN from a finished chaos run would read as fresh again)."""
    cells = getattr(source, "quality", None)
    if cells is None:
        cells = source
    loaded = {name: TensorHealth.from_cell(cell)
              for name, cell in dict(cells).items()}
    global _drift_threshold
    with _base_lock:
        _baseline.clear()
        _baseline.update(loaded)
        _drift_threshold = float(drift_threshold)
        _scores.clear()
        _drift_alerting.clear()


def clear_baseline() -> None:
    with _base_lock:
        _baseline.clear()
        _scores.clear()
        _drift_alerting.clear()


def baseline_stages() -> List[str]:
    with _base_lock:
        return sorted(_baseline)


def _strip_pipeline(name: str) -> str:
    return name.split(":", 1)[1] if ":" in name else name


def score_tick(consumer: str = "default") -> Dict[str, float]:
    """Score every tapped edge's FRESH samples (since ``consumer``'s
    previous tick) and return ``{stage: score}``: fresh NaN/Inf →
    :data:`NONFINITE_SCORE`; a baselined stage with enough fresh finite
    samples → PSI of the fresh histogram against the baseline sketch;
    no fresh traffic → 0.0 (cool-down). Crossings of the installed
    drift threshold record ``quality`` flight events both ways. Each
    ``quality``-kind SLO objective calls this through
    :func:`worst_score` with its own consumer key each engine tick —
    windows are per consumer, so concurrent scorers never starve each
    other."""
    live = default_accountant.stages()
    events: List[Tuple[str, str, dict]] = []
    with _base_lock:
        seen = _last_seen.setdefault(consumer, {})
        scores: Dict[str, float] = {}
        for name, cell in live.items():
            prev = seen.get(name)
            seen[name] = cell
            if prev is None:
                # first sighting: score the whole population once
                prev = {"elems": 0, "nan": 0, "inf": 0, "hist": None}
            d_elems = cell["elems"] - prev["elems"]
            if d_elems <= 0:
                scores[name] = 0.0
                continue
            d_nan = cell["nan"] - prev["nan"]
            d_inf = cell["inf"] - prev["inf"]
            if d_nan > 0 or d_inf > 0:
                scores[name] = NONFINITE_SCORE
            else:
                score = 0.0
                base = _baseline.get(_strip_pipeline(name))
                if base is not None:
                    # fresh histogram = cumulative minus the previous
                    # tick's snapshot (counts are monotone, so the
                    # bucket-wise delta is exact and non-negative)
                    fresh = QuantileDigest.from_dict(cell["hist"])
                    if prev["hist"]:
                        old = QuantileDigest.from_dict(prev["hist"])
                        fresh.count -= old.count
                        fresh._zero -= old._zero
                        for k, c in old._buckets.items():
                            fresh._buckets[k] = fresh._buckets.get(k, 0) - c
                    if fresh.count >= MIN_SCORE_SAMPLES:
                        score = psi(base.hist, fresh)
                scores[name] = score
            key = (consumer, name)
            was = key in _drift_alerting
            now = scores[name] >= _drift_threshold
            detail = {"stage": name, "score": round(scores[name], 4)}
            if consumer != "default":
                detail["consumer"] = consumer
            if now and not was:
                _drift_alerting.add(key)
                detail["threshold"] = _drift_threshold
                events.append((name, "drift", detail))
            elif was and not now:
                _drift_alerting.discard(key)
                events.append((name, "drift_clear", detail))
        # the scrape-time view keeps the latest score per stage across
        # all consumers (a gauge row per consumer would churn labels)
        _scores.update(scores)
    for name, kind, detail in events:
        pipe = name.split(":", 1)[0] if ":" in name else None
        obs_flight.record("quality", kind, detail, pipeline=pipe)
    return dict(scores)


def worst_score(consumer: str = "default") -> float:
    """Worst per-edge drift score right now (rotates ``consumer``'s
    tick window) — the sample the ``quality``-kind SLO objective
    records."""
    scores = score_tick(consumer)
    return max(scores.values(), default=0.0)


def drift_scores() -> Dict[str, float]:
    """The scores computed by the most recent :func:`score_tick` — the
    scrape-time view (reading does NOT rotate the tick windows)."""
    with _base_lock:
        return dict(_scores)


# ---------------------------------------------------------------------------
# canary quality gate (service/models.py promote path)
# ---------------------------------------------------------------------------

class QualityGate:
    """The promote gate's thresholds: maximum primary↔canary output
    divergence (:func:`psi` between the two sketches), maximum *new*
    NaN/Inf fraction the canary may introduce over the primary, the
    minimum samples each side needs before a verdict is meaningful, and
    the mirror cadence (every Nth primary invoke is shadow-run through
    the candidate)."""

    def __init__(self, max_divergence: float = 0.25,
                 max_new_nan_frac: float = 0.0,
                 max_new_inf_frac: float = 0.0,
                 min_samples: int = 8, mirror_every: int = 4):
        if max_divergence <= 0:
            raise ValueError(
                f"max_divergence={max_divergence} must be > 0")
        if min_samples < 1:
            raise ValueError(f"min_samples={min_samples} must be >= 1")
        if mirror_every < 1:
            raise ValueError(f"mirror_every={mirror_every} must be >= 1")
        self.max_divergence = float(max_divergence)
        self.max_new_nan_frac = float(max_new_nan_frac)
        self.max_new_inf_frac = float(max_new_inf_frac)
        self.min_samples = int(min_samples)
        self.mirror_every = int(mirror_every)

    @classmethod
    def from_config(cls, cfg) -> Optional["QualityGate"]:
        """None/False → no gate; True/{} → defaults; a dict sets
        fields; a ready instance passes through."""
        if cfg is None or cfg is False:
            return None
        if cfg is True:
            return cls()
        if isinstance(cfg, cls):
            return cfg
        if isinstance(cfg, dict):
            return cls(**cfg)
        raise ValueError(
            f"quality_gate must be a bool, dict, or QualityGate "
            f"(got {type(cfg).__name__})")

    def spec(self) -> dict:
        return {"max_divergence": self.max_divergence,
                "max_new_nan_frac": self.max_new_nan_frac,
                "max_new_inf_frac": self.max_new_inf_frac,
                "min_samples": self.min_samples,
                "mirror_every": self.mirror_every}


class CanaryQuality:
    """Output-divergence monitor for one canary window, shared by every
    bound filter's router. The gate compares ONLY mirrored pairs:
    every ``mirror_every``-th primary-routed invoke records the
    primary's output AND shadow-runs the candidate on the SAME input
    (output discarded, never served) — both sketches are built over an
    identical input population, so :meth:`verdict`'s drift score
    (:func:`psi` plus NaN/Inf deltas) measures the models, never the
    router's input split. A 1% traffic canary still gathers enough
    candidate samples to gate on, and a candidate that *crashes* on
    live inputs fails the gate without a single client-visible error."""

    def __init__(self, gate: QualityGate):
        self.gate = gate
        self._lock = named_lock("CanaryQuality._lock")
        self.primary = TensorHealth()   # guarded-by: _lock
        self.canary = TensorHealth()    # guarded-by: _lock
        self._n = 0                     # guarded-by: _lock
        self.mirrors = 0                # guarded-by: _lock
        self.mirror_failures = 0        # guarded-by: _lock
        self.last_mirror_error = ""     # guarded-by: _lock

    def should_mirror(self) -> bool:
        with self._lock:
            n = self._n
            self._n += 1
            return n % self.gate.mirror_every == 0

    def _fold(self, cell: TensorHealth, outputs) -> None:
        reduced = []
        for t in outputs if isinstance(outputs, (list, tuple)) else [outputs]:
            r = _reduce_any(t)
            if r is not None:
                reduced.append(r)
        with self._lock:
            cell.buffers += 1
            for elems, ivec, fvec, counts in reduced:
                cell.fold(elems, ivec, fvec, counts)

    def observe_primary(self, outputs) -> None:
        try:
            self._fold(self.primary, outputs)
        except Exception:  # noqa: BLE001 - monitor must never fail a request
            logger.exception("canary quality: primary reduce failed")

    def observe_canary(self, outputs, mirrored: bool = False) -> None:
        try:
            self._fold(self.canary, outputs)
            if mirrored:
                with self._lock:
                    self.mirrors += 1
        except Exception:  # noqa: BLE001 - monitor must never fail a request
            logger.exception("canary quality: canary reduce failed")

    def mirror_failed(self, error: BaseException) -> None:
        """The candidate raised on a mirrored live input — recorded as a
        hard gate failure; the client still got the primary's answer."""
        with self._lock:
            self.mirror_failures += 1
            self.last_mirror_error = f"{type(error).__name__}: {error}"[:200]

    def report(self) -> dict:
        with self._lock:
            divergence = psi(self.primary.hist, self.canary.hist)
            return {
                "gate": self.gate.spec(),
                "divergence": round(divergence, 4),
                "new_nan_frac": max(
                    0.0, self.canary.nan_frac - self.primary.nan_frac),
                "new_inf_frac": max(
                    0.0, self.canary.inf_frac - self.primary.inf_frac),
                "primary": self.primary.snapshot(),
                "canary": self.canary.snapshot(),
                "mirrors": self.mirrors,
                "mirror_failures": self.mirror_failures,
                "last_mirror_error": self.last_mirror_error,
            }

    def verdict(self) -> Tuple[bool, str, dict]:
        """(ok, reason, report) — the promote gate's decision. Too few
        samples on either side refuses: an unobserved candidate is not
        a promotable candidate."""
        rep = self.report()
        g = self.gate
        if rep["mirror_failures"] > 0:
            return False, (f"candidate raised on {rep['mirror_failures']} "
                           f"mirrored input(s): "
                           f"{rep['last_mirror_error']}"), rep
        n_p = rep["primary"]["buffers"]
        n_c = rep["canary"]["buffers"]
        if n_p < g.min_samples or n_c < g.min_samples:
            return False, (f"insufficient samples (primary {n_p}, canary "
                           f"{n_c}, need {g.min_samples} each)"), rep
        if rep["new_nan_frac"] > g.max_new_nan_frac:
            return False, (f"canary introduces NaN (frac "
                           f"{rep['new_nan_frac']:.4g} > "
                           f"{g.max_new_nan_frac:g})"), rep
        if rep["new_inf_frac"] > g.max_new_inf_frac:
            return False, (f"canary introduces Inf (frac "
                           f"{rep['new_inf_frac']:.4g} > "
                           f"{g.max_new_inf_frac:g})"), rep
        if rep["divergence"] > g.max_divergence:
            return False, (f"output divergence {rep['divergence']:.4f} > "
                           f"gate {g.max_divergence:g}"), rep
        return True, "", rep


class SpecAcceptanceGate:
    """Promote arbitration for speculative-decode (draft, target) pairs
    (service/models.py slots carry the pair; serving/speculative.py
    produces the rate). Acceptance is a PERFORMANCE contract, not a
    correctness one — speculative output is token-identical to
    target-only by construction — so the gate guards throughput: a
    draft that stops predicting its target decodes SLOWER than no draft
    at all (every round still pays K draft steps + one verify), and a
    candidate pair must not regress the acceptance the fleet currently
    earns.

    ``min_rate``: absolute floor for the candidate pair's acceptance;
    ``max_drop``: largest tolerated drop vs the active pair's recorded
    rate (ignored when no baseline exists yet);
    ``min_rounds``: speculative rounds the candidate must have run
    before a verdict is meaningful (same stance as
    :class:`QualityGate.min_samples`: unobserved ⇒ unpromotable).
    """

    def __init__(self, min_rate: float = 0.0, max_drop: float = 0.15,
                 min_rounds: int = 16):
        if not 0.0 <= min_rate <= 1.0:
            raise ValueError(f"min_rate={min_rate} must be in [0, 1]")
        if max_drop < 0.0:
            raise ValueError(f"max_drop={max_drop} must be >= 0")
        if min_rounds < 1:
            raise ValueError(f"min_rounds={min_rounds} must be >= 1")
        self.min_rate = float(min_rate)
        self.max_drop = float(max_drop)
        self.min_rounds = int(min_rounds)

    @classmethod
    def from_config(cls, cfg) -> Optional["SpecAcceptanceGate"]:
        """Same contract as :meth:`QualityGate.from_config`."""
        if cfg is None or cfg is False:
            return None
        if cfg is True:
            return cls()
        if isinstance(cfg, cls):
            return cfg
        if isinstance(cfg, dict):
            return cls(**cfg)
        raise ValueError(
            f"acceptance_gate must be a bool, dict, or SpecAcceptanceGate "
            f"(got {type(cfg).__name__})")

    def spec(self) -> dict:
        return {"min_rate": self.min_rate, "max_drop": self.max_drop,
                "min_rounds": self.min_rounds}

    def verdict(self, candidate: Optional[dict],
                baseline: Optional[dict] = None) -> Tuple[bool, str]:
        """(ok, reason). ``candidate``/``baseline`` are
        ``{"rate": float, "rounds": int}`` observations (``None`` =
        never observed). A missing or under-sampled candidate refuses;
        a missing baseline gates on the absolute floor only."""
        if candidate is None:
            return False, ("no speculative-acceptance observation for the "
                           "candidate pair (run it under live/canary "
                           "traffic first)")
        rate = float(candidate.get("rate", 0.0))
        rounds = int(candidate.get("rounds", 0))
        if rounds < self.min_rounds:
            return False, (f"insufficient speculative rounds ({rounds} < "
                           f"{self.min_rounds})")
        if rate < self.min_rate:
            return False, (f"acceptance {rate:.3f} below floor "
                           f"{self.min_rate:g}")
        if baseline is not None:
            base = float(baseline.get("rate", 0.0))
            if base - rate > self.max_drop:
                return False, (f"acceptance {rate:.3f} regresses baseline "
                               f"{base:.3f} by more than {self.max_drop:g}")
        return True, ""


GATE_REFUSALS = obs_metrics.counter(
    "nns_quality_gate_refusals_total",
    "canary promotions refused by the output-quality gate")


# ---------------------------------------------------------------------------
# module-level control
# ---------------------------------------------------------------------------

_ctl_lock = threading.Lock()
_tracer: Optional[_QualityTracer] = None


def start(sample_every: int = 8) -> QualityAccountant:
    """Switch the tensor health taps on: installs the pad tracer and
    arms the fused-segment / serving hooks. One health reduction every
    ``sample_every`` buffers per edge."""
    global ACTIVE, SAMPLE_EVERY, _tracer
    from ..utils import trace

    if sample_every < 1:
        raise ValueError(f"sample_every={sample_every} must be >= 1")
    with _ctl_lock:
        SAMPLE_EVERY = int(sample_every)
        if _tracer is None:
            _tracer = _QualityTracer()
            trace.install_tracer(_tracer)
        ACTIVE = True
    return default_accountant


def stop() -> None:
    """Back to the one-global-check fast path (cells are kept;
    :func:`reset` drops them)."""
    global ACTIVE, _tracer
    from ..utils import trace

    with _ctl_lock:
        ACTIVE = False
        if _tracer is not None:
            trace.uninstall_tracer(_tracer)
            _tracer = None


def reset() -> None:
    default_accountant.reset()
    _serving_n.clear()
    _reduce_failed.clear()
    with _base_lock:
        _last_seen.clear()
        _scores.clear()
        _drift_alerting.clear()


# ---------------------------------------------------------------------------
# snapshot + metrics collector + dashboard section
# ---------------------------------------------------------------------------

def snapshot() -> dict:
    """The ``GET /quality`` document: per-edge health, the installed
    baseline's stages, and the latest drift scores."""
    with _base_lock:
        thr = _drift_threshold
    return {
        "active": ACTIVE,
        "sample_every": SAMPLE_EVERY,
        "stages": default_accountant.snapshots(),
        "baseline": baseline_stages(),
        "drift_threshold": thr,
        "drift": drift_scores(),
    }


_G_BUFFERS = obs_metrics.gauge(
    "nns_quality_buffers_sampled_total",
    "buffers sampled by the tensor health taps", ("stage",))
_G_NAN = obs_metrics.gauge(
    "nns_quality_nan_total", "NaN values observed at the tapped edge",
    ("stage",))
_G_INF = obs_metrics.gauge(
    "nns_quality_inf_total", "Inf values observed at the tapped edge",
    ("stage",))
_G_ZERO = obs_metrics.gauge(
    "nns_quality_zero_fraction", "fraction of exactly-zero values",
    ("stage",))
_G_MEAN = obs_metrics.gauge(
    "nns_quality_mean", "running mean of finite values", ("stage",))
_G_DRIFT = obs_metrics.gauge(
    "nns_quality_drift_score",
    "PSI-style drift score of fresh samples (vs baseline; "
    "NONFINITE_SCORE on fresh NaN/Inf)", ("stage",))


def _collect_quality(_registry) -> None:
    for g in (_G_BUFFERS, _G_NAN, _G_INF, _G_ZERO, _G_MEAN, _G_DRIFT):
        g.clear()
    for name, snap in default_accountant.snapshots().items():
        _G_BUFFERS.set(snap["buffers"], stage=name)
        _G_NAN.set(snap["nan"], stage=name)
        _G_INF.set(snap["inf"], stage=name)
        _G_ZERO.set(snap["zero_frac"], stage=name)
        _G_MEAN.set(snap["mean"], stage=name)
    for name, score in drift_scores().items():
        _G_DRIFT.set(score, stage=name)


obs_metrics.register_collector("quality", _collect_quality)


def render_section(q_snap: dict) -> List[str]:
    """The QUALITY section of ``obs top`` (appended by
    ``profile.render_top`` when a quality snapshot is supplied)."""
    lines: List[str] = []
    stages = q_snap.get("stages") or {}
    if not stages:
        return lines
    drift = q_snap.get("drift") or {}
    lines.append("")
    lines.append(f"QUALITY (taps {'ON' if q_snap.get('active') else 'off'}"
                 f", 1/{q_snap.get('sample_every', SAMPLE_EVERY)} sampled)")
    lines.append(f"  {'stage':<40} {'bufs':>6} {'nan':>6} {'inf':>6} "
                 f"{'zero%':>7} {'mean':>11} {'drift':>8}")
    for name, s in sorted(stages.items()):
        d = drift.get(name)
        lines.append(
            f"  {name:<40} {s['buffers']:>6d} {s['nan']:>6d} "
            f"{s['inf']:>6d} {s['zero_frac'] * 100:>6.1f}% "
            f"{s['mean']:>11.4g} "
            + (f"{d:>8.3f}" if d is not None else f"{'—':>8}"))
    return lines
