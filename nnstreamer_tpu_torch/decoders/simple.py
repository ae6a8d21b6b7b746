"""Simple decoders: direct_video, image_labeling, octet_stream.

Reference analogs (ext/nnstreamer/tensor_decoder/):
  * ``tensordec-directvideo.c`` — tensor → video/x-raw;
  * ``tensordec-imagelabel.c`` — argmax + label file → text;
  * ``tensordec-octetstream.c`` — tensors → opaque bytes.

``tensor_region`` (``tensordec-tensor_region.c``) is not in this package
yet: it needs the SSD box decoding of ``bbox_classic``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, TensorsInfo
from ..core.caps import OCTET_MIME, TEXT_MIME, VIDEO_MIME
from .base import Decoder, register_decoder


def _host_array(t) -> np.ndarray:
    """A host tensor as numpy. numpy has no bfloat16: a CPU
    ``torch.bfloat16`` tensor widens to float32, which is exact, so an
    argmax over it is the bfloat16 argmax."""
    if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
        return t.float().numpy()
    return np.asarray(t)


def _raw_bytes(t) -> bytes:
    """A host tensor's bytes in memory order; a CPU ``torch.bfloat16``
    tensor gives its raw 16-bit words."""
    if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


@register_decoder
class DirectVideo(Decoder):
    """Interpret a (1,H,W,C) / (H,W,C) tensor as a raw video frame."""

    MODE = "direct_video"

    _FMT = {1: "GRAY8", 3: "RGB", 4: "RGBA"}

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        if not in_info.specs:
            return Caps.new(VIDEO_MIME)
        shape = in_info.specs[0].shape
        if len(shape) == 4:
            _, h, w, c = shape
        elif len(shape) == 3:
            h, w, c = shape
        else:
            return None
        fmt = self.option(1, self._FMT.get(c))
        if fmt is None:
            return None
        return Caps.new(VIDEO_MIME, format=fmt, width=w, height=h)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        a = np.asarray(buf.tensors[0])
        if a.ndim == 4:
            a = a[0]
        if a.dtype != np.uint8:
            a = np.clip(a, 0, 255).astype(np.uint8)
        return Buffer([a])

    def make_reduce(self, in_info: TensorsInfo):
        """Device stage: clip and cast to uint8 where the tensor lies —
        float video tensors cross to the host at 1 byte/px instead of 4."""

        def reduce(ts):
            a = ts[0]
            if a.dtype is torch.uint8:
                return (a,)
            return (a.clamp(0, 255).to(torch.uint8),)
        return reduce

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        a = np.asarray(arrays[0])
        if a.ndim == 4:
            a = a[0]
        return Buffer([a])


@register_decoder
class ImageLabeling(Decoder):
    """argmax over class scores + label file → text stream of the label.

    option1 = labels file (one label per line, reference behavior).
    """

    MODE = "image_labeling"

    # at frames-in=1 a (B, C) buffer legacy-decodes to B labels in ONE
    # buffer — the leading axis is not a per-buffer frame count, so the
    # device reduction must not re-interpret it (elements/decoder.py)
    FI1_DEVICE_REDUCE = False

    def init(self, options):
        super().init(options)
        self.labels: List[str] = []
        path = self.option(1)
        if path:
            with open(path) as fh:
                self.labels = [ln.strip() for ln in fh if ln.strip()]

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        return Caps.new(TEXT_MIME)

    def _label(self, i: int) -> str:
        return self.labels[i] if i < len(self.labels) else str(i)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        scores = _host_array(buf.tensors[0])
        # batched input (aggregator upstream): one label per leading-dim
        # frame; the reference only ever sees batch=1. The leading axis is
        # a batch only when the remaining axes hold the class scores — a
        # (C,1) single-frame layout must not split.
        if scores.ndim >= 2 and scores.shape[0] > 1 and np.prod(scores.shape[1:]) > 1:
            idxs = [int(i) for i in scores.reshape(scores.shape[0], -1).argmax(-1)]
        else:
            idxs = [int(np.argmax(scores.reshape(-1)))]
        labels = [self._label(i) for i in idxs]
        out = Buffer([np.frombuffer("\n".join(labels).encode(), np.uint8)])
        out.meta["label_index"] = idxs[0]
        out.meta["label"] = labels[0]
        out.meta["label_indices"] = idxs
        out.meta["labels"] = labels
        return out

    def make_reduce(self, in_info: TensorsInfo):
        """Device stage: argmax over class scores where they lie — one
        int32 per frame crosses to the host instead of the score vector.

        Engages only when the per-frame layout yields ONE label per frame
        (leading dim 1 / 1-D scores): a per-frame leading dim d0 > 1 means
        the host path emits d0 labels per frame, and a flattened argmax
        here would encode row*C+class — device and host paths must emit
        the same labels, so those layouts (and flexible specs) stay on
        the host."""
        if not in_info.specs:
            return None  # flexible stream: per-frame layout unknowable here
        shape = in_info.specs[0].shape
        if len(shape) >= 2 and shape[0] > 1:
            return None

        def reduce(ts):
            s = ts[0]
            return (torch.argmax(s.reshape(s.shape[0], -1), -1).to(torch.int32),)
        return reduce

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        i = int(arrays[0])
        label = self._label(i)
        out = Buffer([np.frombuffer(label.encode(), np.uint8)])
        out.meta["label_index"] = i
        out.meta["label"] = label
        out.meta["label_indices"] = [i]
        out.meta["labels"] = [label]
        return out


@register_decoder
class OctetStream(Decoder):
    MODE = "octet_stream"

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        return Caps.new(OCTET_MIME)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        raw = b"".join(_raw_bytes(t) for t in buf.tensors)
        return Buffer([np.frombuffer(raw, np.uint8)])
