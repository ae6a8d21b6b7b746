"""MobileNet-v2 as a torch module — the image-labeling bench model.

The port of nnstreamer_tpu's ``models/mobilenet_v2.py``:

    tensor_src dimensions=3:224:224:1 types=uint8 pattern=random
      ! tensor_aggregator frames-out=64 ! queue
      ! tensor_filter framework=torch
          model=nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8
      ! tensor_decoder mode=image_labeling frames-in=64 ! tensor_sink

NHWC at the pipeline boundary, ``channels_last`` inside, compute in
bfloat16 on the card and float32 on the CPU (``compute_dtype="auto"``),
inference-mode batch norm folded into a per-channel scale and bias. A
float32 build computes in full float32 on the card too (no TF32).

Entries (backends/torch_backend.py): ``make(device)`` builds the served
callable on ``device`` (default the card). It maps ``(B, H, W, 3)`` →
``(B, num_classes)`` float32 logits and carries ``output_info``, the
shape rule caps negotiation uses instead of running the model. Weights
are random, from ``seed``, unless the entry carries ``params``:
nnstreamer_tpu's flax parameter tree as numpy arrays, converted by
``models/convert.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..core import DataType, TensorSpec, TensorsInfo
from .convert import mobilenet_params_from_flax
from ._blocks import (
    ConvBnRelu,
    InvertedResidual,
    ServedModel,
    image_input_shape,
    make_u8_entry,
    place_model,
)

# (expansion t, output channels c, repeats n, stride s) — the standard
# MobileNet-v2 body configuration
_BODY = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


class MobileNetV2(nn.Module):
    """``forward(x)``: (B, H, W, 3) NHWC → (B, num_classes) float32."""

    def __init__(self, num_classes: int = 1001, width_mult: float = 1.0):
        super().__init__()

        def ch(c: int) -> int:
            return max(8, int(c * width_mult + 4) // 8 * 8)

        self.stem = ConvBnRelu(3, ch(32), (3, 3), strides=2)
        blocks, in_ch = [], ch(32)
        for t, c, n, s in _BODY:
            for i in range(n):
                blocks.append(InvertedResidual(in_ch, ch(c), s if i == 0 else 1, t))
                in_ch = ch(c)
        self.blocks = nn.ModuleList(blocks)
        self.head = ConvBnRelu(in_ch, ch(1280), (1, 1))
        self.fc = nn.Linear(ch(1280), num_classes)
        self.fc.requires_grad_(False)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the one the parameters are held in."""
        return self.fc.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a contiguous NHWC tensor permuted to NCHW is channels_last
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.stem(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.head(x).mean(dim=(2, 3))  # global average pool
        return self.fc(x).float()

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        b, _, _ = image_input_shape(in_info, "mobilenet_v2")
        return TensorsInfo.of(TensorSpec((b, self.fc.out_features),
                                         DataType.FLOAT32))


def build_mobilenet_v2(num_classes: int = 1001, width_mult: float = 1.0,
                       compute_dtype: str = "auto", device=None, seed: int = 0,
                       params: Optional[Dict[str, Any]] = None) -> MobileNetV2:
    """The model on ``device`` (None = the card) in eval mode, weights in
    the compute dtype: random from ``seed`` (a CPU ``torch.Generator``, so
    the card and the CPU get the same weights), or ``params``, a flax tree
    of nnstreamer_tpu's ``build_mobilenet_v2`` as numpy arrays."""
    return place_model(MobileNetV2(num_classes, width_mult), compute_dtype,
                       device, seed, params, mobilenet_params_from_flax)


@dataclass(frozen=True)
class _FilterEntry:
    """``tensor_filter framework=torch
    model=nnstreamer_tpu_torch.models.mobilenet_v2:filter_model``."""

    num_classes: int = 1001
    width_mult: float = 1.0
    compute_dtype: str = "auto"
    seed: int = 0
    # nnstreamer_tpu's flax parameter tree (numpy leaves); None = random
    params: Optional[Dict[str, Any]] = field(default=None, compare=False,
                                             repr=False)

    def make(self, device=None) -> ServedModel:
        return ServedModel(build_mobilenet_v2(
            self.num_classes, self.width_mult, self.compute_dtype, device,
            self.seed, self.params))


filter_model = _FilterEntry()
filter_model_u8 = make_u8_entry(filter_model)
# the same model info with other random weights: the target of a hot
# swap (``tensor_filter.reload_model``) on a line serving filter_model
filter_model_seed1 = _FilterEntry(seed=1)
# ... and for a line serving filter_model_u8: the second version of a
# model slot in a swap or canary (service/models.py)
filter_model_u8_seed1 = make_u8_entry(filter_model_seed1)
