"""tensor_debug: passthrough stream inspector (L3).

Reference analog: ``gsttensor_debug.c`` (441 LoC; output-mode enums
gsttensor_debug.h:47-74) — logs caps/shape/timestamps without altering flow.

The counterpart of nnstreamer_tpu's ``elements/debug.py``.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..core import Buffer, Caps
from ..core.caps import any_media_caps
from ..registry.elements import register_element
from ..runtime.element import Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger


def _flagish(v) -> bool:
    """Reference debug properties are GFlags/GEnum: numeric flag values
    and words like 'all'/'enabled' mean on, 0/'none'/'disabled' off."""
    s = str(v).strip().lower()
    if s.lstrip("-").isdigit():
        return int(s) != 0
    if s in ("all", "enabled", "enable"):
        return True
    if s in ("none", "disabled", "disable"):
        return False
    return prop_bool(v)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return str(np.asarray(t).dtype)


@register_element
class TensorDebug(TransformElement):
    ELEMENT_NAME = "tensor_debug"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, any_media_caps()),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, any_media_caps()),)
    PROPERTIES = {
        "output_mode": Prop("log", str, "log | console | none"),
        "capsinfo": Prop(True, _flagish, "print caps on negotiation"),
        "metainfo": Prop(True, _flagish, "print per-buffer shapes/timestamps"),
    }
    # the reference's property spellings (gsttensor_debug.c:249-271:
    # output-method flags, capability enum, metadata flags — numeric flag
    # words accepted via _flagish)
    PROP_ALIASES = {
        "output_method": "output_mode",
        "capability": "capsinfo",
        "metadata": "metainfo",
    }

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        if self.props["capsinfo"] and self._emitting():
            self._emit(f"{self.name} caps: {caps}")

    def _emitting(self) -> bool:
        """True when the description string would actually go anywhere —
        per-buffer dtype/shape formatting is the expensive part, so skip
        building it for output-mode=none or a disabled INFO logger."""
        mode = self.props["output_mode"]
        if mode == "none":
            return False
        if mode == "console":
            return True
        return logger.isEnabledFor(logging.INFO)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if self.props["metainfo"] and self._emitting():
            # a torch tensor's dtype is read off the tensor: a CUDA
            # tensor is never pulled to the host to be described
            shapes = ", ".join(
                f"{_dtype_name(t)}{tuple(t.shape)}" for t in buf.tensors
            )
            self._emit(f"{self.name} buf pts={buf.pts} offset={buf.offset} [{shapes}]")
        return buf

    def _emit(self, text: str) -> None:
        if self.props["output_mode"] == "console":
            print(text)
        else:
            logger.info("%s", text)
