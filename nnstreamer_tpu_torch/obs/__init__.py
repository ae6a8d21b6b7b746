"""nnstreamer_tpu_torch.obs — the observability plane (L7).

The port of the parts of nnstreamer_tpu's ``obs/`` package that the
serving layer uses:

* :mod:`.context` — request-scoped tracing: trace contexts, spans (batch
  spans *link* to the N coalesced request spans), Perfetto/chrome-trace
  export; gated on one module global (:data:`~.context.TRACING`);
* :mod:`.flight` — the always-on crash flight recorder, a lock-free
  bounded ring of recent control-plane events;
* :mod:`.metrics` — a Prometheus-style registry that serving schedulers,
  KV page pools and speculative engines publish into, rendered by
  :func:`~.metrics.render`;
* :mod:`.memory` — serving byte sources, the admission guard and live
  device bytes from ``torch.cuda``.

Not in this package yet: ``profile``, ``slo``, ``quality``, ``fleet``,
``promtext`` and the rest of ``memory`` (ROADMAP.md, queue A).
"""
from . import context, flight, memory, metrics  # noqa: F401
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
from .memory import AdmissionGuard  # noqa: F401
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricError,
    Registry,
    default_registry,
    render,
)

__all__ = [
    "AdmissionGuard",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricError",
    "Registry",
    "Span",
    "TraceContext",
    "context",
    "default_registry",
    "disable_tracing",
    "enable_tracing",
    "export_chrome_trace",
    "finished_spans",
    "flight",
    "memory",
    "metrics",
    "record_span",
    "render",
    "spans_for_trace",
    "start_span",
]
