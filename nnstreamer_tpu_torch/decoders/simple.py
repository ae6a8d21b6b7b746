"""Simple decoders: direct_video, image_labeling, octet_stream,
tensor_region.

Reference analogs (ext/nnstreamer/tensor_decoder/):
  * ``tensordec-directvideo.c`` — tensor → video/x-raw;
  * ``tensordec-imagelabel.c`` — argmax + label file → text;
  * ``tensordec-octetstream.c`` — tensors → opaque bytes;
  * ``tensordec-tensor_region.c`` — detections → crop regions consumed by
    tensor_crop (not in this package yet).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, TensorFormat, TensorsInfo
from ..core.caps import OCTET_MIME, TEXT_MIME, VIDEO_MIME, caps_from_tensors_info
from .base import Decoder, host_array, register_decoder, top_k


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
        scores = host_array(buf.tensors[0])
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


@register_decoder
class TensorRegion(Decoder):
    """Detections → (N,4) crop regions [x,y,w,h] for tensor_crop.

    Two input modes, dispatched on option3:

    * **simplified** (no option3): boxes (N,4) normalized
      [ymin,xmin,ymax,xmax] + scores (N,) or (N,classes); option1 =
      number of regions (default 1), option2 = "W:H" frame size to
      denormalize to (default 1:1 = keep normalized). Output int32.
    * **mobilenet-ssd** (option3 = box-priors file, the reference's
      semantics — ``tensordec-tensor_region.c``): raw SSD heads
      [boxes (N,4) center offsets; class logits (N,C)]; option1 = number
      of regions, option2 = labels file (present for reference-CLI
      compatibility; the decode itself only needs the logits), option4 =
      input video size "W:H" (default 300:300). Decode matches the
      reference exactly: first above-threshold class (:436-476 ``break``),
      +1-inclusive integer NMS at IoU 0.5, zero-padded uint32 output of
      exactly ``num`` regions (nnstreamer_tpu's copy is proven byte for
      byte against the reference's fixture corpus in
      tests/test_reference_parity.py).
    """

    MODE = "tensor_region"

    def init(self, options):
        super().init(options)
        self.num = int(self.option(1, "1"))
        self.priors = None
        priors = self.option(3)
        if priors:
            from .bbox_classic import load_priors_txt

            self.priors = (np.load(priors).astype(np.float32).T
                           if priors.endswith(".npy") else load_priors_txt(priors))
            wh = self.option(4, "300:300").split(":")
            self.in_width, self.in_height = int(wh[0]), int(wh[1])
        else:
            wh = self.option(2, "1:1").split(":")
            self.frame_w, self.frame_h = int(wh[0]), int(wh[1])

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        return caps_from_tensors_info(TensorsInfo((), TensorFormat.FLEXIBLE))

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        if self.priors is not None:
            from . import bbox_classic as bc

            dets = bc.parse_mobilenet_ssd(
                host_array(buf.tensors[0]).reshape(-1, 4),
                host_array(buf.tensors[1]),
                self.priors, self.in_width, self.in_height,
                class_select="first")
            dets = bc.nms_classic(dets, 0.5)
            out = np.zeros((self.num, 4), np.uint32)
            for i, d in enumerate(dets[: self.num]):
                out[i] = (d.x, d.y, d.width, d.height)
            return Buffer([out])
        boxes = host_array(buf.tensors[0]).reshape(-1, 4).astype(np.float32)
        scores = host_array(buf.tensors[1]).astype(np.float32) if buf.num_tensors > 1 else None
        if scores is not None:
            if scores.ndim > 1:
                scores = scores.max(axis=-1)
            order = np.argsort(-scores.reshape(-1))[: self.num]
        else:
            order = np.arange(min(self.num, boxes.shape[0]))
        return self._regions_from(boxes[order])

    def _regions_from(self, sel: np.ndarray) -> Buffer:
        ymin, xmin, ymax, xmax = sel[:, 0], sel[:, 1], sel[:, 2], sel[:, 3]
        x = np.round(xmin * self.frame_w).astype(np.int32)
        y = np.round(ymin * self.frame_h).astype(np.int32)
        w = np.round((xmax - xmin) * self.frame_w).astype(np.int32)
        h = np.round((ymax - ymin) * self.frame_h).astype(np.int32)
        return Buffer([np.stack([x, y, w, h], axis=1)])

    def make_reduce(self, in_info: TensorsInfo):
        """Device stage for the SIMPLIFIED mode only: top-num selection
        where the batch lies, (num, 4) rows per frame cross to the host.
        The priors (reference byte-parity) mode never reduces."""
        if self.priors is not None:
            return None
        num = self.num

        def reduce(ts):
            boxes = ts[0].reshape(ts[0].shape[0], -1, 4).float()
            if len(ts) > 1:
                s = ts[1].float()
                s = s.reshape(boxes.shape[0], boxes.shape[1], -1).amax(-1)
                _, idx = top_k(s, min(num, boxes.shape[1]))
                sel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            else:
                sel = boxes[:, :num]
            return (sel,)
        return reduce

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        return self._regions_from(np.asarray(arrays[0]))
