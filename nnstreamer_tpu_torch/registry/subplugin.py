"""Subplugin registry (L2).

Reference analog: ``gst/nnstreamer/nnstreamer_subplugin.c`` — per-type hash
tables (FILTER/DECODER/CONVERTER/TRAINER, :139-293; the port has FILTER,
DECODER and CONVERTER so far) populated by ``.so``
constructors after lazy ``g_module_open``. Python redesign: per-type dicts
populated by ``@register(kind, name)`` decorators at import time; lazy loading
resolves a not-yet-registered name by importing (a) the built-in module for
that kind and (b) any module paths listed in the config's ``subplugin_modules``
key (the ini ``[common] subplugin_dirs`` analog, SURVEY.md §2.2).
"""
from __future__ import annotations

import enum
import importlib
import threading
from typing import Any, Callable, Dict, List, Optional

from ..utils.log import logger


class SubpluginKind(enum.Enum):
    FILTER = "filter"        # NN framework backends
    DECODER = "decoder"      # tensor_decoder modes
    CONVERTER = "converter"  # tensor_converter external parsers


_REGISTRY: Dict[SubpluginKind, Dict[str, Any]] = {k: {} for k in SubpluginKind}
_ALIASES: Dict[SubpluginKind, Dict[str, str]] = {k: {} for k in SubpluginKind}
_lock = threading.RLock()

# Built-in modules imported on first lookup of each kind (the reference's
# scan-all-subplugin-dirs mode, nnstreamer_subplugin.c:108). The port's
# table names only its own modules.
_BUILTIN_MODULES: Dict[SubpluginKind, tuple] = {
    SubpluginKind.FILTER: (
        "nnstreamer_tpu_torch.backends.torch_backend",
        "nnstreamer_tpu_torch.backends.python_backend",
        "nnstreamer_tpu_torch.backends.custom_easy",
        "nnstreamer_tpu_torch.backends.custom_c",
        "nnstreamer_tpu_torch.backends.tflite_backend",
        "nnstreamer_tpu_torch.backends.tf_backend",
    ),
    SubpluginKind.DECODER: ("nnstreamer_tpu_torch.decoders",),
    SubpluginKind.CONVERTER: ("nnstreamer_tpu_torch.converters",),
}
_scanned: Dict[SubpluginKind, bool] = {k: False for k in SubpluginKind}


def register(kind: SubpluginKind, name: str, obj: Any = None, aliases=()):
    """Register a subplugin (decorator or direct call).

    Reference: ``register_subplugin`` (nnstreamer_subplugin.c:223); aliases
    play the role of ini ``[filter-aliases]``.
    """

    def _do(o):
        with _lock:
            if name in _REGISTRY[kind]:
                logger.debug("subplugin %s/%s re-registered", kind.value, name)
            _REGISTRY[kind][name] = o
            for a in aliases:
                _ALIASES[kind][a] = name
        return o

    return _do if obj is None else _do(obj)


def get(kind: SubpluginKind, name: str) -> Any:
    """Resolve a subplugin by name, lazily importing providers.

    Reference: ``get_subplugin`` (nnstreamer_subplugin.c:139).
    """
    with _lock:
        found = _lookup(kind, name)
        if found is not None:
            return found
        _scan_builtin(kind)
        _scan_configured(kind)
        found = _lookup(kind, name)
        if found is not None:
            return found
        raise KeyError(
            f"no {kind.value} subplugin '{name}' (known: {sorted(_REGISTRY[kind])})"
        )


def _lookup(kind: SubpluginKind, name: str) -> Optional[Any]:
    reg = _REGISTRY[kind]
    if name in reg:
        return reg[name]
    real = _ALIASES[kind].get(name)
    return reg.get(real) if real else None


def _scan_builtin(kind: SubpluginKind) -> None:
    if _scanned[kind]:
        return
    _scanned[kind] = True
    for mod in _BUILTIN_MODULES.get(kind, ()):
        importlib.import_module(mod)


def _scan_configured(kind: SubpluginKind) -> None:
    from .config import get_config

    extra = get_config().get("common", f"subplugin_modules_{kind.value}", "")
    for mod in filter(None, (m.strip() for m in extra.split(","))):
        try:
            importlib.import_module(mod)
        except ImportError:
            logger.warning("configured subplugin module %s failed to import", mod)


def names_csv(kind: SubpluginKind) -> str:
    """Registered subplugin names as one comma-joined string — the value
    of the reference's read-only ``sub-plugins`` element property."""
    return ",".join(names(kind))


def names(kind: SubpluginKind) -> List[str]:
    with _lock:
        _scan_builtin(kind)
        return sorted(_REGISTRY[kind])
