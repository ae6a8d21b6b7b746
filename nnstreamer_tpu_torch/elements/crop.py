"""tensor_crop: crop a tensor stream by another stream's region values (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_crop.c`` (824 LoC) —
two sink pads: ``raw`` (data, e.g. video tensor) and ``info`` (crop regions,
e.g. detected bboxes from the tensor_region decoder); output is FLEXIBLE
format since each frame's crop count/size varies.

Region tensor layout: (N, 4) [x, y, w, h] per region (matching the
tensor_region decoder output), cropping the last-but-one two axes (H, W) of
a (..., H, W, C) raw tensor.

The counterpart of nnstreamer_tpu's ``elements/crop.py``: host-affine
and a fusion barrier there too; a CUDA frame is pulled once per pair.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
)
from ..core.buffer import is_host_bf16
from ..registry.elements import register_element
from ..runtime.element import Element, Prop
from ..runtime.pad import Pad, PadDirection, PadTemplate


@register_element
class TensorCrop(Element):
    ELEMENT_NAME = "tensor_crop"
    SINK_TEMPLATES = (
        PadTemplate("raw", PadDirection.SINK, Caps.new("other/tensors")),
        PadTemplate("info", PadDirection.SINK, Caps.new("other/tensors")),
    )
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    DEVICE_AFFINITY = "host"  # per-region slicing runs on host arrays
    # barrier text surfaced by NNL010/NNL013 (see runtime/fusion.py)
    FUSION_BARRIER = "host per-region slicing (dynamic shapes per region)"
    PROPERTIES = {
        # reference gsttensor_crop.c lateness (ms): tolerated pts distance
        # between the raw frame and its crop-info frame; -1 = pair blindly
        "lateness": Prop(-1, int,
                         "max |raw.pts - info.pts| in ms to accept a pair "
                         "(-1 = no check; late info drops the raw frame)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._raw_q: List[Buffer] = []
        self._info_q: List[Buffer] = []
        self._crop_lock = threading.Lock()

    def transform_caps(self, src_pad: Pad) -> Caps:
        return caps_from_tensors_info(TensorsInfo((), TensorFormat.FLEXIBLE))

    def chain(self, pad: Pad, buf: Buffer) -> None:
        with self._crop_lock:
            (self._raw_q if pad.name == "raw" else self._info_q).append(buf)
            if not (self._raw_q and self._info_q):
                return
            raw = self._raw_q.pop(0)
            info = self._info_q.pop(0)
        lateness = self.props["lateness"]
        if (lateness >= 0 and raw.pts is not None and info.pts is not None
                and abs(raw.pts - info.pts) * 1000.0 > lateness):
            return  # info too far from this frame: drop the pair
        frame = raw.as_numpy().tensors[0]
        if not is_host_bf16(frame):  # host bfloat16 is sliced in torch
            frame = np.asarray(frame)
        regions = np.asarray(info.as_numpy().tensors[0]).reshape(-1, 4).astype(np.int64)
        # crop H/W: frame is (..., H, W, C); leading axes preserved
        h_ax, w_ax = frame.ndim - 3, frame.ndim - 2
        crops = []
        for x, y, w, h in regions:
            sl = [slice(None)] * frame.ndim
            sl[h_ax] = slice(max(y, 0), max(y, 0) + max(h, 0))
            sl[w_ax] = slice(max(x, 0), max(x, 0) + max(w, 0))
            crop = frame[tuple(sl)]
            crops.append(crop.contiguous() if isinstance(crop, torch.Tensor)
                         else np.ascontiguousarray(crop))
        out = Buffer(crops).copy_metadata_from(raw)
        self.push(out)
