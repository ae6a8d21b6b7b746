"""DeepLab-v3-style semantic segmentation as a torch module — the
image_segment bench model.

The port of nnstreamer_tpu's ``models/deeplab.py``:

    tensor_src dimensions=3:224:224:1 types=uint8 pattern=random
      ! tensor_aggregator frames-out=64 frames-dim=0 concat=true ! queue
      ! tensor_filter framework=torch
          model=nnstreamer_tpu_torch.models.deeplab:filter_model_u8
      ! queue ! tensor_decoder mode=image_segment option1=tflite-deeplab
          frames-in=64 ! tensor_sink

A MobileNet-v2-style trunk at output stride 16 (its last two blocks
dilated by 2 instead of strided), an ASPP-lite head (a 1×1 branch, 3×3
branches dilated 6 and 12, and an image-pooling branch, fused by a 1×1),
a 1×1 classifier, and a bilinear upsample to the input size on the
device (half-pixel centres, edges clamped: ``jax.image.resize`` in
nnstreamer_tpu, ``F.interpolate(align_corners=False)`` here). Output:
(B, H, W, num_classes) float32 logits. Weights are random (from
``seed``), or nnstreamer_tpu's flax tree carried by ``models/convert.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import DataType, TensorSpec, TensorsInfo
from .convert import deeplab_params_from_flax
from ._blocks import (
    Conv,
    ConvBnRelu,
    InvertedResidual,
    ServedModel,
    image_input_shape,
    make_u8_entry,
    place_model,
)

_NUM_CLASSES = 21  # PASCAL-VOC
# (features, stride, expand, dilation) of the trunk's inverted residuals
_TRUNK = [(16, 1, 1, 1), (24, 2, 6, 1), (24, 1, 6, 1), (32, 2, 6, 1),
          (32, 1, 6, 1), (64, 2, 6, 1), (64, 1, 6, 1), (96, 1, 6, 2),
          (96, 1, 6, 2)]
_ASPP_WIDTH = 128
_ASPP_DILATIONS = (6, 12)


class DeepLab(nn.Module):
    """``forward(x)``: (B, H, W, 3) NHWC → (B, H, W, num_classes) float32
    logits."""

    def __init__(self, num_classes: int = _NUM_CLASSES):
        super().__init__()
        self.num_classes = num_classes
        self.stem = ConvBnRelu(3, 32, (3, 3), strides=2)
        blocks, in_ch = [], 32
        for c, s, t, d in _TRUNK:
            blocks.append(InvertedResidual(in_ch, c, s, t, dilation=d))
            in_ch = c
        self.blocks = nn.ModuleList(blocks)
        wd = _ASPP_WIDTH
        self.aspp = nn.ModuleList(
            [ConvBnRelu(in_ch, wd, (1, 1))]
            + [ConvBnRelu(in_ch, wd, (3, 3), dilation=d)
               for d in _ASPP_DILATIONS])
        self.pool_proj = ConvBnRelu(in_ch, wd, (1, 1))
        self.fuse = ConvBnRelu(wd * (len(self.aspp) + 1), wd, (1, 1))
        self.classifier = Conv(wd, num_classes, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_h, in_w = x.shape[1], x.shape[2]
        x = self.stem(x.to(self.stem.weight.dtype).permute(0, 3, 1, 2))
        for blk in self.blocks:
            x = blk(x)
        branches = [m(x) for m in self.aspp]
        img = self.pool_proj(x.mean(dim=(2, 3), keepdim=True))
        branches.append(img.expand_as(branches[0]))
        x = self.fuse(torch.cat(branches, dim=1))
        x = self.classifier(x).float()
        # on-device bilinear upsample to the input size
        x = F.interpolate(x, size=(in_h, in_w), mode="bilinear",
                          align_corners=False)
        return x.permute(0, 2, 3, 1).contiguous()

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        b, h, w = image_input_shape(in_info, "deeplab")
        return TensorsInfo.of(TensorSpec((b, h, w, self.num_classes),
                                         DataType.FLOAT32))


def build_deeplab(num_classes: int = _NUM_CLASSES, compute_dtype: str = "auto",
                  device=None, seed: int = 0,
                  params: Optional[Dict[str, Any]] = None) -> DeepLab:
    """The model on ``device`` (None = the card), weights in the compute
    dtype: random from ``seed``, or ``params``, nnstreamer_tpu's
    ``build_deeplab`` flax tree as numpy arrays."""
    return place_model(DeepLab(num_classes), compute_dtype, device, seed,
                       params, deeplab_params_from_flax)


@dataclass(frozen=True)
class _FilterEntry:
    """``tensor_filter framework=torch
    model=nnstreamer_tpu_torch.models.deeplab:filter_model`` → feeds
    ``tensor_decoder mode=image_segment option1=tflite-deeplab``."""

    num_classes: int = _NUM_CLASSES
    compute_dtype: str = "auto"
    seed: int = 0
    # nnstreamer_tpu's flax parameter tree (numpy leaves); None = random
    params: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                             repr=False)

    def make(self, device=None) -> ServedModel:
        return ServedModel(build_deeplab(self.num_classes, self.compute_dtype,
                                         device, self.seed, self.params))


filter_model = _FilterEntry()
filter_model_u8 = make_u8_entry(filter_model)
