"""Reference user-API compatibility shims.

``nnstreamer_python`` (ext/nnstreamer/extra/nnstreamer_python3_helper.cc)
is the module the reference injects into embedded user scripts — decoder /
converter / filter .py files written for the reference import it for
``TensorShape``. :func:`install_nnstreamer_python` registers the port's
re-implementation under that name so those scripts run here unmodified,
as nnstreamer_tpu's ``compat`` package does.
"""
from __future__ import annotations

import sys

from . import nnstreamer_python


def install_nnstreamer_python() -> None:
    """Make ``import nnstreamer_python`` resolve to the shim (idempotent;
    a user-installed real module wins if already imported)."""
    sys.modules.setdefault("nnstreamer_python", nnstreamer_python)


__all__ = ["install_nnstreamer_python", "nnstreamer_python"]
