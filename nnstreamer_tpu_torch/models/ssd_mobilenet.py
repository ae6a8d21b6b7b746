"""SSD-MobileNet object detection as a torch module — the bounding-box
bench model.

The port of nnstreamer_tpu's ``models/ssd_mobilenet.py``:

    tensor_src dimensions=3:224:224:1 types=uint8 pattern=random
      ! tensor_aggregator frames-out=64 frames-dim=0 concat=true ! queue
      ! tensor_filter framework=torch
          model=nnstreamer_tpu_torch.models.ssd_mobilenet:filter_model_u8
      ! queue ! tensor_decoder mode=bounding_boxes
          option1=mobilenet-ssd-postprocess option3=,30 option4=224:224
          frames-in=64 ! tensor_sink

A MobileNet-v2-style trunk emitting stride-8/16/32/64 features, one
3×3 location head and one 3×3 class head per stride (3 aspects each), and
the centre-variance box decode and sigmoid on the device: the filter
emits boxes (B, N, 4) [ymin,xmin,ymax,xmax] and scores (B, N, C), float32.
``filter_model_raw`` emits the raw locations and logits for the
priors-file path (``option1=mobilenet-ssd`` with ``save_anchors``).

Candidate order is nnstreamer_tpu's, kept as it is: each head's NHWC
output (B, H, W, A·4) is reshaped to (B, H·W·A, 4), so candidates run
cell-major and aspect-minor, while ``make_anchors`` lists the anchors
aspect-major within each stride; the decode pairs them index by index.
The heads here run NCHW (channels_last), so they are permuted to NHWC
before the reshape.

Weights are random (from ``seed``), or nnstreamer_tpu's flax tree carried
by ``models/convert.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import DataType, TensorSpec, TensorsInfo
from .convert import ssd_params_from_flax
from ._blocks import (
    Conv,
    ConvBnRelu,
    InvertedResidual,
    ServedModel,
    image_input_shape,
    make_u8_entry,
    place_model,
)

# per-stride anchor config: (scale, aspect ratios)
_ANCHOR_SCALES = (0.15, 0.35, 0.55, 0.8)
_ASPECTS = (1.0, 2.0, 0.5)
_VARIANCES = (0.1, 0.1, 0.2, 0.2)  # standard SSD box-coding variances
STRIDES = (8, 16, 32, 64)

# (features, stride, expand) of the trunk's inverted residuals; a feature
# map is tapped after blocks 4 (stride 8), 7 (stride 16) and 9 (stride 32)
_TRUNK = [(16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
          (64, 2, 6), (64, 1, 6), (96, 1, 6), (160, 2, 6), (160, 1, 6)]
_TAPS = (4, 7, 9)


def make_anchors(image_size: int, strides: Sequence[int]) -> np.ndarray:
    """Prior boxes as (N, 4) [cy, cx, h, w], normalized, float32."""
    all_boxes: List[np.ndarray] = []
    for scale, stride in zip(_ANCHOR_SCALES, strides):
        # the trunk's SAME-padded stride-2 convs yield ceil-sized feature
        # maps (iterated ceil-div-2 == ceil(size/stride))
        fm = -(-image_size // stride)
        centers = (np.arange(fm, dtype=np.float32) + 0.5) / fm
        cy, cx = np.meshgrid(centers, centers, indexing="ij")
        for ar in _ASPECTS:
            h = scale / np.sqrt(ar)
            w = scale * np.sqrt(ar)
            boxes = np.stack(
                [cy.ravel(), cx.ravel(),
                 np.full(fm * fm, h, np.float32),
                 np.full(fm * fm, w, np.float32)],
                axis=1,
            )
            all_boxes.append(boxes.astype(np.float32))
    return np.concatenate(all_boxes, axis=0)


def decode_boxes_np(loc: np.ndarray, anchors: np.ndarray,
                    variances: Sequence[float] = _VARIANCES) -> np.ndarray:
    """Host-side center-variance decode (used by the decoder's raw
    ``mobilenet-ssd`` mode; mirrors the on-device decode below)."""
    vy, vx, vh, vw = variances
    cy = loc[:, 0] * vy * anchors[:, 2] + anchors[:, 0]
    cx = loc[:, 1] * vx * anchors[:, 3] + anchors[:, 1]
    h = anchors[:, 2] * np.exp(loc[:, 2] * vh)
    w = anchors[:, 3] * np.exp(loc[:, 3] * vw)
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=1)


class SSDMobileNet(nn.Module):
    """``forward(x)``: (B, S, S, 3) NHWC → (boxes (B, N, 4), scores (B, N,
    C)) float32, S = ``image_size``; ``raw(x)`` → (locations (B, N, 4),
    logits (B, N, C)) float32."""

    def __init__(self, num_classes: int = 91, image_size: int = 224):
        super().__init__()
        self.num_classes, self.image_size = num_classes, image_size
        self.stem = ConvBnRelu(3, 32, (3, 3), strides=2)
        blocks, in_ch, feat_ch = [], 32, []
        for i, (c, s, t) in enumerate(_TRUNK):
            blocks.append(InvertedResidual(in_ch, c, s, t))
            in_ch = c
            if i in _TAPS:
                feat_ch.append(c)
        self.blocks = nn.ModuleList(blocks)
        self.extra = ConvBnRelu(in_ch, 128, (3, 3), strides=2)  # stride 64
        feat_ch.append(128)
        a = len(_ASPECTS)
        self.loc_heads = nn.ModuleList(Conv(c, a * 4) for c in feat_ch)
        self.conf_heads = nn.ModuleList(Conv(c, a * num_classes)
                                        for c in feat_ch)
        self.anchors = make_anchors(image_size, STRIDES)
        self._anchors_on: Dict[torch.device, torch.Tensor] = {}

    def _anchors(self, device: torch.device) -> torch.Tensor:
        # float32 whatever the compute dtype: not a buffer, which .to()
        # would cast
        if device not in self._anchors_on:
            self._anchors_on[device] = torch.from_numpy(self.anchors).to(device)
        return self._anchors_on[device]

    def raw(self, x: torch.Tensor):
        dtype = self.stem.weight.dtype
        # a contiguous NHWC tensor permuted to NCHW is channels_last
        x = self.stem(x.to(dtype).permute(0, 3, 1, 2))
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in _TAPS:
                feats.append(x)
        feats.append(self.extra(x))
        b = x.shape[0]
        # NHWC before the reshape: candidates cell-major, aspect-minor
        locs = [head(f).permute(0, 2, 3, 1).reshape(b, -1, 4)
                for head, f in zip(self.loc_heads, feats)]
        confs = [head(f).permute(0, 2, 3, 1).reshape(b, -1, self.num_classes)
                 for head, f in zip(self.conf_heads, feats)]
        return torch.cat(locs, 1).float(), torch.cat(confs, 1).float()

    def forward(self, x: torch.Tensor):
        loc, conf = self.raw(x)
        anc = self._anchors(loc.device)
        vy, vx, vh, vw = _VARIANCES
        # on-device center-variance decode → [ymin,xmin,ymax,xmax]
        cy = loc[..., 0] * vy * anc[:, 2] + anc[:, 0]
        cx = loc[..., 1] * vx * anc[:, 3] + anc[:, 1]
        h = anc[:, 2] * torch.exp(loc[..., 2] * vh)
        w = anc[:, 3] * torch.exp(loc[..., 3] * vw)
        boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                            dim=-1)
        return boxes, torch.sigmoid(conf)

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        b, h, w = image_input_shape(in_info, "ssd_mobilenet")
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(
                f"ssd_mobilenet: its anchors are for {self.image_size}x"
                f"{self.image_size} frames, got {h}x{w}")
        n = len(self.anchors)
        return TensorsInfo.of(
            TensorSpec((b, n, 4), DataType.FLOAT32),
            TensorSpec((b, n, self.num_classes), DataType.FLOAT32))


def build_ssd_mobilenet(num_classes: int = 91, image_size: int = 224,
                        compute_dtype: str = "auto", device=None,
                        seed: int = 0,
                        params: Optional[Dict[str, Any]] = None
                        ) -> SSDMobileNet:
    """The model on ``device`` (None = the card), weights in the compute
    dtype (``auto``: bfloat16 on the card, float32 on the CPU): random
    from ``seed``, or ``params``, nnstreamer_tpu's ``build_ssd_mobilenet``
    flax tree as numpy arrays."""
    return place_model(SSDMobileNet(num_classes, image_size), compute_dtype,
                       device, seed, params, ssd_params_from_flax)


@dataclass(frozen=True)
class _FilterEntry:
    """``tensor_filter framework=torch
    model=nnstreamer_tpu_torch.models.ssd_mobilenet:filter_model`` —
    decoded boxes and scores, for ``tensor_decoder mode=bounding_boxes
    option1=mobilenet-ssd-postprocess``; with ``raw`` the locations and
    logits, for ``option1=mobilenet-ssd`` and an anchors file."""

    num_classes: int = 91
    image_size: int = 224
    compute_dtype: str = "auto"
    seed: int = 0
    raw: bool = False
    # nnstreamer_tpu's flax parameter tree (numpy leaves); None = random
    params: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                             repr=False)

    def make(self, device=None) -> ServedModel:
        model = build_ssd_mobilenet(self.num_classes, self.image_size,
                                    self.compute_dtype, device, self.seed,
                                    self.params)
        if not self.raw:
            return ServedModel(model)
        return ServedModel(model, model.raw, model.output_info)


filter_model = _FilterEntry()
filter_model_raw = _FilterEntry(raw=True)
filter_model_u8 = make_u8_entry(filter_model)


def save_anchors(path: str, image_size: int = 224) -> None:
    """Write the prior boxes as a .npy file (the decoder's option for the
    raw mode; the reference ships box_priors.txt with its test models)."""
    np.save(path, make_anchors(image_size, STRIDES))
