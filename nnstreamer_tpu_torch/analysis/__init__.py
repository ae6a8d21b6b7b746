"""Analysis: the graph lint (``graph_lint.py``, rules ``NNL0xx``), the
five source passes and the runtime sanitizers (``sanitizer.py``).

The port of nnstreamer_tpu's ``analysis/`` package. Its passes share one
diagnostic model (``diagnostics.py``) and rule catalog with the
reference:

* **graph lint** (`lint_pipeline` / `lint_launch` / `lint_pbtxt`, rules
  ``NNL0xx``): validates a parsed-but-not-started pipeline (caps/shape/
  dtype propagation over every pad link, topology, registry
  cross-checks, perf hazards, the fusion plan NNL013 and the placement
  hint NNL014); the service plane's admission check and
  ``Pipeline(validate=True)`` run it;
* **source lint** (`lint_source`, ``NNL1xx``): host syncs
  (``torch.cuda.synchronize``, ``.cpu()``/``.item()``/...) and scalar
  pulls in hot loops, bare/silent excepts, blocking calls in batch
  formation, Python branches on a captured or exported function's
  tensor parameters;
* **concurrency lint** (`lint_concurrency`, ``NNL2xx``): lock-order
  inversions, ``# guarded-by:`` contracts, blocking under a lock,
  predicate-less ``Condition.wait``, threads without a join path;
* **lifecycle lint** (`lint_lifecycle`, ``NNL3xx``): acquire/release
  pairs on every path, refcount balance, subprocess reaping, atomic
  writes, unregister-at-stop (``# pairs-with:`` annotations);
* **transfer lint** (`lint_transfer`, ``NNL4xx``): a device/host
  dataflow — implicit device→host pulls in hot scopes, per-frame device
  allocations, host round-trip sandwiches, whole-buffer wire copies
  (NNL404, donation, has no PyTorch counterpart and never fires);
* **protocol lint** (`lint_protocol`, ``NNL5xx``): the wire contract of
  the ``query/``/``transport/`` codecs.

CLI: ``python -m nnstreamer_tpu_torch lint <pbtxt | launch-string | pkg>``;
with no target it is the strict self-lint of this package. Intentional
findings are suppressed in-source with ``# nnlint: disable=NNLxxx``
pragmas.
"""
from .concurrency_lint import lint_concurrency  # noqa: F401
from .diagnostics import RULES, Diagnostic, Severity  # noqa: F401
from .graph_lint import lint_launch, lint_pbtxt, lint_pipeline  # noqa: F401
from .lifecycle_lint import lint_lifecycle  # noqa: F401
from .protocol_lint import lint_protocol  # noqa: F401
from .source_lint import lint_source  # noqa: F401
from .transfer_lint import lint_transfer  # noqa: F401

__all__ = [
    "RULES",
    "Diagnostic",
    "Severity",
    "lint_concurrency",
    "lint_launch",
    "lint_lifecycle",
    "lint_pbtxt",
    "lint_pipeline",
    "lint_protocol",
    "lint_source",
    "lint_transfer",
]
