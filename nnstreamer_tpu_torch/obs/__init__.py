"""nnstreamer_tpu_torch.obs — the observability plane (L7).

The port of nnstreamer_tpu's ``obs/`` package. One contract across it:
near-zero cost when idle (one module-global check per hook).

* :mod:`.context` — request-scoped tracing: trace contexts, spans (batch
  spans *link* to the N coalesced request spans), Perfetto/chrome-trace
  export; gated on one module global (:data:`~.context.TRACING`);
* :mod:`.flight` — the always-on crash flight recorder, a lock-free
  bounded ring of recent control-plane events;
* :mod:`.metrics` — a Prometheus-style registry that serving schedulers,
  KV page pools, speculative engines and the obs modules publish into,
  rendered by :func:`~.metrics.render`;
* :mod:`.profile` — the continuous profiler: wall time attributed per
  element / queue-wait hop / served request into mergeable
  streaming-quantile digests (:class:`~.profile.QuantileDigest`),
  persisted as **profile artifacts** keyed by (topology hash, caps,
  model version) with load/merge/diff APIs — interchangeable with the
  reference's;
* :mod:`.slo` — declarative objectives (latency, error rate,
  availability, memory pressure, output quality) evaluated from the same
  windowed digests with multi-window burn-rate alerting;
* :mod:`.quality` — the data plane's numerical health: sampled tensor
  taps on pad hops and serving batch outputs (NaN/Inf/zero counts,
  moments, a log-bucket value sketch; device tensors reduced on their
  own device), per-edge baselines, PSI drift scoring and the canary
  quality gates;
* :mod:`.memory` — per-stage byte estimates (:class:`MemoryAccountant`),
  live device bytes from ``torch.cuda``, queue occupancy bytes, serving
  byte sources and the admission guard.

Not in this package yet: ``fleet`` and ``promtext`` (ROADMAP A6).
"""
from . import (  # noqa: F401
    context,
    flight,
    memory,
    metrics,
    profile,
    quality,
    slo,
)
from .memory import AdmissionGuard, MemoryAccountant  # noqa: F401
from .quality import (  # noqa: F401
    CanaryQuality,
    QualityAccountant,
    QualityGate,
    TensorHealth,
)
from .context import (  # noqa: F401
    Span,
    TraceContext,
    disable_tracing,
    enable_tracing,
    export_chrome_trace,
    finished_spans,
    record_span,
    spans_for_trace,
    start_span,
)
from .flight import FlightRecorder  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricError,
    Registry,
    default_registry,
    render,
)
from .profile import (  # noqa: F401
    ProfileArtifact,
    ProfileStore,
    Profiler,
    QuantileDigest,
    WindowedSeries,
    topology_hash,
)
from .slo import SloEngine, SLObjective  # noqa: F401

__all__ = [
    "AdmissionGuard",
    "CanaryQuality",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MemoryAccountant",
    "MetricError",
    "QualityAccountant",
    "QualityGate",
    "TensorHealth",
    "ProfileArtifact",
    "ProfileStore",
    "Profiler",
    "QuantileDigest",
    "Registry",
    "SLObjective",
    "SloEngine",
    "Span",
    "TraceContext",
    "WindowedSeries",
    "context",
    "default_registry",
    "disable_tracing",
    "enable_tracing",
    "export_chrome_trace",
    "finished_spans",
    "flight",
    "memory",
    "metrics",
    "profile",
    "quality",
    "record_span",
    "render",
    "slo",
    "spans_for_trace",
    "start_span",
    "topology_hash",
]
