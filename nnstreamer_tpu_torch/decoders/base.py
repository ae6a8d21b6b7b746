"""Decoder subplugin vtable (L2).

Reference analog: ``GstTensorDecoderDef``
(gst/nnstreamer/include/nnstreamer_plugin_api_decoder.h:39-97 —
``modename/init/exit/setOption/getOutCaps/decode``). Options arrive as the
``option1..option12`` strings of the tensor_decoder element.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, TensorsInfo
from ..registry.subplugin import SubpluginKind, register


def host_array(t) -> np.ndarray:
    """A host tensor as numpy. numpy has no bfloat16: a CPU
    ``torch.bfloat16`` tensor widens to float32, which is exact, so what a
    decoder computes from it is what it computes from the bfloat16
    values."""
    if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
        return t.float().numpy()
    return np.asarray(t)


def top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest of each row and their indices, largest first.
    Equal scores keep index order, as ``lax.top_k`` does in
    nnstreamer_tpu's reduces; ``torch.topk`` promises no order among ties
    on the card, so this is a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Decoder:
    MODE = ""

    # Whether the device reduction may engage at frames-in=1 (the leading
    # axis is then the frame's own dim, unambiguous for image-shaped
    # modes). Decoders whose legacy decode() gives the leading axis a
    # DIFFERENT per-buffer meaning at fi=1 (image_labeling: (B, C) host
    # batch → B labels in ONE buffer) opt out.
    FI1_DEVICE_REDUCE = True

    def init(self, options: List[Optional[str]]) -> None:
        """Receive option1..optionN (None where unset)."""
        self.options = options

    def option(self, n: int, default: Optional[str] = None) -> Optional[str]:
        """1-based option access."""
        if 1 <= n <= len(self.options) and self.options[n - 1] is not None:
            return self.options[n - 1]
        return default

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        raise NotImplementedError

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        raise NotImplementedError

    # ---- device-side reduction -------------------------------------------
    #
    # The reference decodes on host from the full model output. On a card
    # that is a full-width device→host copy per frame. A decoder that
    # implements ``make_reduce`` splits decoding into two stages:
    #
    #   reduce  (torch ops on the tensors' device, batched): raw tensors →
    #           compact tensors (argmax indices, uint8 frames)
    #   decode_reduced (host, per frame): compact arrays → media
    #
    # The tensor_decoder element runs ``reduce`` on the batch where it
    # lies, BEFORE any transfer, so only the reduced tensors cross to the
    # host — one pull for a whole aggregated batch.

    def make_reduce(self, in_info: TensorsInfo):
        """Return a plain ``fn(tensors) -> tuple[torch.Tensor]`` where
        every input/output carries a leading batch axis, or None when the
        decoder only decodes raw tensors on host (the default)."""
        return None

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        """Host finish for one frame of ``make_reduce`` outputs (each
        array has the batch axis already stripped)."""
        raise NotImplementedError


def register_decoder(cls):
    register(SubpluginKind.DECODER, cls.MODE, cls)
    return cls
