"""Analysis: the graph lint (``graph_lint.py``, rules ``NNL0xx``) and the
runtime sanitizers (``sanitizer.py``).

The port of part of nnstreamer_tpu's ``analysis/`` package. The graph
lint validates a parsed-but-not-started pipeline (caps/shape/dtype
propagation over every pad link, topology, registry cross-checks, perf
hazards) and shares one diagnostic model (``diagnostics.py``) with the
reference; the service plane's admission check runs it. The source,
concurrency, lifecycle, transfer and protocol lint passes are not in
this package yet.
"""
from .diagnostics import RULES, Diagnostic, Severity  # noqa: F401
from .graph_lint import lint_launch, lint_pbtxt, lint_pipeline  # noqa: F401

__all__ = [
    "RULES",
    "Diagnostic",
    "Severity",
    "lint_launch",
    "lint_pbtxt",
    "lint_pipeline",
]
