"""PoseNet-style keypoint heatmap model as a torch module — the
pose_estimation bench model.

The port of nnstreamer_tpu's ``models/posenet.py``:

    tensor_src dimensions=3:224:224:1 types=uint8 pattern=random
      ! tensor_aggregator frames-out=64 frames-dim=0 concat=true ! queue
      ! tensor_filter framework=torch
          model=nnstreamer_tpu_torch.models.posenet:filter_model_u8
      ! queue ! tensor_decoder mode=pose_estimation option1=224:224
          option2=heatmap frames-in=64 ! tensor_sink

A MobileNet-v2-style trunk to stride 8 and a 1×1 head of K=17 COCO
keypoint channels: (B, H, W, 3) → (B, ⌈H/8⌉, ⌈W/8⌉, K) float32 sigmoid
heatmaps. Fully convolutional, so any frame size works. Weights are
random (from ``seed``), or nnstreamer_tpu's flax tree carried by
``models/convert.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..core import DataType, TensorSpec, TensorsInfo
from .convert import posenet_params_from_flax
from ._blocks import (
    Conv,
    ConvBnRelu,
    InvertedResidual,
    ServedModel,
    image_input_shape,
    make_u8_entry,
    place_model,
)

_NUM_KEYPOINTS = 17
# (features, stride, expand) of the trunk's inverted residuals
_TRUNK = [(16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
          (64, 1, 6), (96, 1, 6)]


class PoseNet(nn.Module):
    """``forward(x)``: (B, H, W, 3) NHWC → (B, ⌈H/8⌉, ⌈W/8⌉, K) float32
    sigmoid heatmaps."""

    def __init__(self, num_keypoints: int = _NUM_KEYPOINTS):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.stem = ConvBnRelu(3, 32, (3, 3), strides=2)
        blocks, in_ch = [], 32
        for c, s, t in _TRUNK:
            blocks.append(InvertedResidual(in_ch, c, s, t))
            in_ch = c
        self.blocks = nn.ModuleList(blocks)
        self.head = Conv(in_ch, num_keypoints, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.to(self.stem.weight.dtype).permute(0, 3, 1, 2))
        for blk in self.blocks:
            x = blk(x)
        heat = torch.sigmoid(self.head(x).float())
        return heat.permute(0, 2, 3, 1).contiguous()

    def keypoints(self, x: torch.Tensor) -> torch.Tensor:
        """Argmax decode on the device → (B, K, 2) normalized [x, y]."""
        hm = self(x)
        b, hh, ww, kk = hm.shape
        idx = torch.argmax(hm.reshape(b, hh * ww, kk), dim=1)  # (B, K)
        # nnstreamer_tpu divides by a constant, which XLA compiles as a
        # multiply by its float32 reciprocal
        ry = float(np.float32(1) / np.float32(max(hh - 1, 1)))
        rx = float(np.float32(1) / np.float32(max(ww - 1, 1)))
        ys = torch.div(idx, ww, rounding_mode="floor").float() * ry
        xs = (idx % ww).float() * rx
        return torch.stack([xs, ys], dim=-1)

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        b, h, w = image_input_shape(in_info, "posenet")
        return TensorsInfo.of(TensorSpec(
            (b, -(-h // 8), -(-w // 8), self.num_keypoints), DataType.FLOAT32))


def build_posenet(num_keypoints: int = _NUM_KEYPOINTS,
                  compute_dtype: str = "auto", device=None, seed: int = 0,
                  params: Optional[Dict[str, Any]] = None) -> PoseNet:
    """The model on ``device`` (None = the card), weights in the compute
    dtype: random from ``seed``, or ``params``, nnstreamer_tpu's
    ``build_posenet`` flax tree as numpy arrays."""
    return place_model(PoseNet(num_keypoints), compute_dtype, device, seed,
                       params, posenet_params_from_flax)


@dataclass(frozen=True)
class _FilterEntry:
    """``tensor_filter framework=torch
    model=nnstreamer_tpu_torch.models.posenet:filter_model`` → feeds
    ``tensor_decoder mode=pose_estimation option2=heatmap``."""

    num_keypoints: int = _NUM_KEYPOINTS
    compute_dtype: str = "auto"
    seed: int = 0
    # nnstreamer_tpu's flax parameter tree (numpy leaves); None = random
    params: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                             repr=False)

    def make(self, device=None) -> ServedModel:
        return ServedModel(build_posenet(self.num_keypoints,
                                         self.compute_dtype, device,
                                         self.seed, self.params))


filter_model = _FilterEntry()
filter_model_u8 = make_u8_entry(filter_model)
