"""PyTorch execution backend (``framework=torch``, alias ``pytorch``).

The counterpart of nnstreamer_tpu's ``backends/jax_backend.py``: PyTorch on
the card is the pipeline's execution engine. Inputs move to the backend's
device once per frame, the model runs eagerly, and outputs stay on the
device so the next stage reads them there.

Model sources accepted by the ``model`` property (this slice):
  * ``<module>:<attr>`` — an import path to a callable, or to an entry
    object with ``make(device)`` (e.g. ``models/lm_serving.py``), which
    builds the callable on the backend's device.

Device choice (``_select_device``): ``accelerator=cpu`` runs on the CPU;
``custom=device:N`` pins ``cuda:N``; otherwise ``cuda:0``. Without a card,
opening fails unless the CPU was asked for — there is no quiet fallback.

Shape inference: caps negotiation must not run the model (at the ``base``
LM width one invoke is a whole 64-step generate). The served callable
declares a shape rule instead — an ``output_info(in_info)`` attribute
returning the output ``TensorsInfo`` — which costs no device work. A
callable without one gets flexible output caps.
"""
from __future__ import annotations

import importlib
import os
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..core import TensorsInfo
from ..models.lm_serving import with_serve_knobs
from ..utils.hw_accel import device_for_accelerator
from ..utils.log import logger
from .base import Accelerator, FilterBackend, FilterProperties, register_backend


def _apply_serve_knobs(entry, custom: dict, model: str):
    """``custom=serve_dtype:bfloat16,cache_len:640`` on a module:attr
    entry (models/lm_serving.py — bf16 weights+KV cache, right-sized
    cache)."""
    cl = custom.get("cache_len") or "0"
    try:
        cache_len = int(cl)
    except ValueError:
        raise ValueError(f"custom=cache_len:{cl!r} is not an integer")
    return with_serve_knobs(entry, custom.get("serve_dtype"), cache_len,
                            model)


def _select_device(props: FilterProperties) -> torch.device:
    idx = props.custom_dict().get("device")
    if idx is None:
        return device_for_accelerator(props.accelerator.value)
    if props.accelerator is Accelerator.CPU:
        raise ValueError(
            f"custom=device:{idx} names a CUDA device and conflicts "
            "with accelerator=cpu")
    try:
        i = int(idx)
    except ValueError:
        raise ValueError(f"custom=device:{idx!r} is not a device index")
    if i < 0:
        raise ValueError(f"custom=device:{i} must be >= 0")
    return device_for_accelerator(f"cuda:{i}")


@register_backend
class TorchBackend(FilterBackend):
    NAME = "torch"
    ALIASES = ("pytorch",)

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable] = None
        self._device: Optional[torch.device] = None
        # the module:attr object after the serve knobs were applied
        self.model_entry: Any = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        self._device = _select_device(props)
        self._fn = self._load_model(props.model, props)
        logger.info("torch backend opened model=%s device=%s",
                    props.model, self._device)

    def close(self) -> None:
        self._fn = None
        self.model_entry = None
        super().close()

    @property
    def device(self) -> Optional[torch.device]:
        """The device this backend runs on."""
        return self._device

    def _load_model(self, model: str, props: FilterProperties) -> Callable:
        if ":" in model and not os.path.exists(model):
            mod_name, _, attr = model.partition(":")
            entry = getattr(importlib.import_module(mod_name), attr)
            entry = _apply_serve_knobs(entry, props.custom_dict(), model)
            self.model_entry = entry
            maker = getattr(entry, "make", None)
            return maker(device=self._device) if maker else entry
        raise ValueError(
            f"torch backend cannot load model '{model}' (expected "
            "'<module>:<attr>')")

    def set_input_info(self, in_info: TensorsInfo) -> Optional[TensorsInfo]:
        rule = getattr(self._fn, "output_info", None)
        return rule(in_info) if rule is not None else None

    def _to_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
            if not x.flags.writeable:  # torch.from_numpy needs a writable array
                x = x.copy()
            x = torch.from_numpy(x)
        return x.to(self._device)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        if self._fn is None:
            raise RuntimeError("torch backend: invoke before open")
        xs = [self._to_device(x) for x in inputs]
        with torch.inference_mode():
            out = self._fn(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]
