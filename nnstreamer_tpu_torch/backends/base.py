"""Filter backend vtable (L2) — the NN-framework plug-in interface.

Reference analog: ``GstTensorFilterFramework`` V1
(gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:274 — ``open``,
``close``, ``invoke``, ``getModelInfo{GET_IN_OUT_INFO,SET_INPUT_INFO}``,
``eventHandler{RELOAD_MODEL,...}``) and the shared-model table (:578-617). The reference has 23 such backends wrapping
tflite/TF/torch/TensorRT/EdgeTPU/...; in this package PyTorch on CUDA *is*
the execution engine (``torch_backend``), behind the same vtable semantics.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import TensorsInfo
from ..registry.subplugin import SubpluginKind, register


class Accelerator(enum.Enum):
    """Reference ``accl_hw`` (nnstreamer_plugin_api_filter.h:80-102), mapped
    to the devices PyTorch targets here."""

    AUTO = "auto"
    CPU = "cpu"
    GPU = "gpu"


class BackendEvent(enum.Enum):
    """Reference ``event_ops`` for ``eventHandler`` (:470-490); the port
    raises the one its filter uses."""

    RELOAD_MODEL = "reload-model"


@dataclass
class FilterProperties:
    """Open-time properties handed to a backend (reference
    ``GstTensorFilterProperties``)."""

    model: str = ""
    custom: str = ""                      # free-form "key:value,key2:v2" string
    accelerator: Accelerator = Accelerator.AUTO
    # the placement planner's card for a filter it placed
    # (runtime/placement.py); a user's custom=device:N wins over it
    placement_device: Optional[int] = None

    def custom_dict(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for part in self.custom.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition(":")
            out[k.strip()] = v.strip()
        return out


class FilterBackend:
    """Abstract NN backend. One instance = one opened model.

    Lifecycle: ``open()`` → [``get_model_info``/``set_input_info``] →
    ``invoke()``×N → ``close()``. The filter element serializes invokes.
    """

    NAME = ""
    ALIASES: Sequence[str] = ()
    # where the backend can run (reference accl_hw support list); host
    # backends narrow it and refuse the rest (check_accelerator)
    ACCELERATORS: Sequence[Accelerator] = (Accelerator.CPU, Accelerator.GPU)

    def __init__(self):
        self.props: Optional[FilterProperties] = None

    # -- vtable -------------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        self.props = props

    def close(self) -> None:
        self.props = None

    def invoke(self, inputs: List[Any]) -> List[Any]:
        """Run the model on one frame's tensors. Arrays may be numpy or
        torch tensors; returning CUDA tensors keeps data on the device for
        the next stage."""
        raise NotImplementedError

    def fusion_callable(self):
        """A pure per-frame callable for the device-segment fusion
        compiler (``runtime/fusion.py``) — ``fn(*tensors) -> tuple`` on
        tensors already on this backend's device, making no host
        transfer or sync so a CUDA graph can capture it — or None when
        this backend's invoke cannot inline into a segment (host
        interpreters, pinned execution). The default is None: only
        backends whose invoke IS device work opt in."""
        return None

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        """(input_info, output_info); either may be None if the model cannot
        declare it (then ``set_input_info`` is probed — reference
        GET_IN_OUT_INFO vs SET_INPUT_INFO)."""
        return None, None

    def set_input_info(self, in_info: TensorsInfo) -> Optional[TensorsInfo]:
        """Given a concrete input spec, return the output spec (dynamic-shape
        models — reference SET_INPUT_INFO), or None when the backend cannot
        tell without running the model (output caps are then flexible).
        Negotiation never runs a model here: a full-width generate during
        caps negotiation would cost as much as a request."""
        return None

    def handle_event(self, event: BackendEvent, data: Optional[dict] = None) -> None:
        """Optional event hook (model reload etc.)."""

    def release_retired(self) -> None:
        """Drop what a RELOAD_MODEL retired (the old model's weights).
        The filter calls this once no queued device work can still read
        them; backends that retire nothing need not override it."""


class FrameworkUnavailable(RuntimeError):
    """A backend's framework is not installed on this host (the tflite
    and tensorflow backends without TensorFlow). Raised from ``open``, so
    a pipeline posts it as a bus ERROR instead of running the model some
    other way."""


def import_tensorflow(backend_name: str):
    """``import tensorflow`` for a backend's ``open``, or
    :class:`FrameworkUnavailable` naming it."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise FrameworkUnavailable(
            f"framework={backend_name} needs tensorflow, which is not "
            f"installed here ({e}); framework=torch runs a .tflite file "
            "through the package's own importer") from e
    return tf


def check_accelerator(backend: FilterBackend, props: FilterProperties) -> None:
    """Refuse an ``accelerator=`` the backend cannot run on (reference
    ``accl_hw`` support lists): the filter posts the error on the bus
    instead of running quietly somewhere else. ``auto`` is always
    accepted."""
    acc, supported = props.accelerator, backend.ACCELERATORS
    if acc is not Accelerator.AUTO and acc not in supported:
        raise ValueError(
            f"framework={backend.NAME} runs on "
            f"{', '.join(a.value for a in supported)} only, not "
            f"accelerator={acc.value}")


def probe_output_info(backend: FilterBackend,
                      in_info: TensorsInfo) -> TensorsInfo:
    """The output spec of one invoke on host zeros — nnstreamer_tpu's
    default ``set_input_info`` (the reference's SET_INPUT_INFO probe),
    for the host backends whose models declare no shape rule. Bfloat16
    zeros, which numpy lacks, are a CPU ``torch.bfloat16`` tensor."""
    import numpy as np
    import torch

    from ..core import DataType
    from ..core.tensors import TensorSpec

    outs = backend.invoke([
        torch.zeros(s.shape, dtype=torch.bfloat16)
        if s.dtype is DataType.BFLOAT16 else np.zeros(s.shape, s.dtype.np_dtype)
        for s in in_info.specs])
    return TensorsInfo.of(
        *(TensorSpec(tuple(o.shape), DataType.from_any(o.dtype))
          for o in outs))


def register_backend(cls):
    """Class decorator: register a FilterBackend (reference
    ``nnstreamer_filter_probe`` from the ELF constructor)."""
    register(SubpluginKind.FILTER, cls.NAME, cls, aliases=cls.ALIASES)
    return cls


# ---------------------------------------------------------------------------
# Shared-model table: N filter elements sharing one opened backend instance.
# Reference: shared model representation API
# (nnstreamer_plugin_api_filter.h:578-617, keyed by "shared-tensor-filter-key").
# ---------------------------------------------------------------------------

_shared: Dict[str, "_SharedEntry"] = {}
_shared_lock = threading.Lock()


@dataclass
class _SharedEntry:
    backend: FilterBackend
    signature: tuple = ()
    refcount: int = 0


def acquire_backend(name: str, props: FilterProperties, share_key: str = "") -> FilterBackend:
    """Instantiate-and-open a backend; with ``share_key``, reuse an existing
    opened instance (refcounted). Reuse requires the same framework/model —
    the reference's shared-model table likewise rejects incompatible reuse."""
    from ..registry.subplugin import get

    if not share_key:
        backend: FilterBackend = get(SubpluginKind.FILTER, name)()
        backend.open(props)
        return backend
    signature = (name, props.model, props.custom)
    with _shared_lock:
        entry = _shared.get(share_key)
        if entry is None:
            backend = get(SubpluginKind.FILTER, name)()
            backend.open(props)
            entry = _SharedEntry(backend, signature)
            _shared[share_key] = entry
        elif entry.signature != signature:
            raise ValueError(
                f"shared-tensor-filter-key '{share_key}' already bound to "
                f"{entry.signature}, cannot rebind to {signature}"
            )
        entry.refcount += 1
        return entry.backend


def release_backend(backend: FilterBackend, share_key: str = "") -> None:
    if not share_key:
        backend.close()
        return
    with _shared_lock:
        entry = _shared.get(share_key)
        if entry is None or entry.backend is not backend:
            backend.close()
            return
        entry.refcount -= 1
        if entry.refcount <= 0:
            del _shared[share_key]
            backend.close()
