"""Element factory registry (L2).

Reference analog: the gst plugin registration in
``gst/nnstreamer/registerer/nnstreamer.c:94-121`` where every element factory
is registered by name. Elements self-register via the ``@register_element``
decorator at import time; ``load_standard_elements()`` imports the built-in
element modules (the reference's single ``plugin_init``).
"""
from __future__ import annotations

import difflib
import importlib
from typing import Dict, List, Optional, Type

from ..runtime.element import Element, merged_properties  # noqa: F401

_FACTORIES: Dict[str, Type[Element]] = {}


def register_element(cls: Type[Element]) -> Type[Element]:
    name = cls.ELEMENT_NAME
    if not name:
        raise ValueError(f"{cls.__name__} has no ELEMENT_NAME")
    _FACTORIES[name] = cls
    return cls


_STANDARD_MODULES = (
    "nnstreamer_tpu_torch.runtime.queue_factory",
    "nnstreamer_tpu_torch.elements.src",
    "nnstreamer_tpu_torch.elements.sink",
    "nnstreamer_tpu_torch.elements.filter",
    "nnstreamer_tpu_torch.elements.decoder",
    "nnstreamer_tpu_torch.elements.aggregator",
    "nnstreamer_tpu_torch.elements.generate",
    "nnstreamer_tpu_torch.elements.trainer",
    "nnstreamer_tpu_torch.elements.tee",
    "nnstreamer_tpu_torch.elements.media",
    "nnstreamer_tpu_torch.elements.converter",
    "nnstreamer_tpu_torch.elements.transform",
    "nnstreamer_tpu_torch.elements.serving",
    "nnstreamer_tpu_torch.elements.fault",
    "nnstreamer_tpu_torch.elements.muxdemux",
    "nnstreamer_tpu_torch.elements.mergesplit",
    "nnstreamer_tpu_torch.elements.cond",
    "nnstreamer_tpu_torch.elements.crop",
    "nnstreamer_tpu_torch.elements.rate",
    "nnstreamer_tpu_torch.elements.repo",
    "nnstreamer_tpu_torch.elements.sparse",
    "nnstreamer_tpu_torch.elements.debug",
    "nnstreamer_tpu_torch.elements.join",
    "nnstreamer_tpu_torch.elements.files",
    "nnstreamer_tpu_torch.elements.datarepo",
    "nnstreamer_tpu_torch.elements.iio",
    "nnstreamer_tpu_torch.elements.shard",
    "nnstreamer_tpu_torch.elements.mqtt",
    "nnstreamer_tpu_torch.query.elements",
    "nnstreamer_tpu_torch.query.grpc_io",
)

_loaded = False


def load_standard_elements() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in _STANDARD_MODULES:
        importlib.import_module(mod)


def _allowed(factory_name: str) -> bool:
    """Element restriction allowlist (reference: meson
    ``enable-element-restriction`` writing ``[element-restriction]
    enable_element_restriction=True / allowed_elements=...`` into
    nnstreamer.ini — products ship pipelines limited to a vetted element
    set). Two spellings accepted:

    * the reference's ini section: ``[element-restriction]`` with
      ``enable_element_restriction`` + ``allowed_elements``;
    * the shorthand ``[common] restricted_elements`` (allowlist implied
      enabled when non-empty).
    """
    from .config import get_config

    cfg = get_config()
    if cfg.get_bool("element-restriction", "enable_element_restriction", False):
        # explicitly enabled: fail CLOSED — an empty/absent allowlist
        # under an enabled lockdown denies everything, it does not
        # silently disable the vetting
        allow = cfg.get("element-restriction", "allowed_elements", "")
        return factory_name in {e.strip() for e in allow.split(",") if e.strip()}
    allow = cfg.get("common", "restricted_elements", "")
    if not allow.strip():  # shorthand key: empty means no restriction
        return True
    return factory_name in {e.strip() for e in allow.split(",") if e.strip()}


def suggest_element(factory_name: str) -> Optional[str]:
    """Closest registered factory name for a typo, or None (the
    did-you-mean helper of make_element's error)."""
    load_standard_elements()
    matches = difflib.get_close_matches(
        factory_name, list(_FACTORIES), n=1, cutoff=0.55)
    return matches[0] if matches else None


def _unknown_element_msg(factory_name: str) -> str:
    hint = suggest_element(factory_name)
    dym = f" — did you mean '{hint}'?" if hint else ""
    return f"no such element '{factory_name}'{dym} (known: {sorted(_FACTORIES)})"


def make_element(factory_name: str, name=None, **props) -> Element:
    load_standard_elements()
    if factory_name not in _FACTORIES:
        raise ValueError(_unknown_element_msg(factory_name))
    if not _allowed(factory_name):
        raise PermissionError(
            f"element '{factory_name}' is not in the configured "
            "restricted_elements allowlist"
        )
    return _FACTORIES[factory_name](name=name, **props)


def element_factories() -> List[str]:
    load_standard_elements()
    return sorted(_FACTORIES)


def get_factory(factory_name: str) -> Type[Element]:
    """The element class for a factory name (no instantiation)."""
    load_standard_elements()
    if factory_name not in _FACTORIES:
        raise ValueError(_unknown_element_msg(factory_name))
    return _FACTORIES[factory_name]
