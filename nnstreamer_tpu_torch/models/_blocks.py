"""Shared building blocks for the model zoo, as torch modules.

The counterparts of nnstreamer_tpu's ``models/_blocks.py``: inference-mode
BN folded to a per-channel scale and bias, relu6, TF "SAME" padding. The
pipeline boundary is NHWC (``(B, H, W, C)`` tensors); inside, the blocks
take NCHW-shaped tensors in ``channels_last`` memory, which is what
``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor already is.

Modules are built in float32 and moved to the compute dtype with
``.to()``; parameters are then held in it (nnstreamer_tpu keeps them in
float32 and casts at use, which gives the same values).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.hw_accel import resolve_device
from .tflite_import import conv2d_same

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(compute_dtype: Union[str, torch.dtype],
                          device=None) -> torch.dtype:
    """``auto`` → bfloat16 on a card (tensor-core bf16, half the bytes),
    float32 on the CPU; ``device`` as for :func:`resolve_device` (None =
    the card). Explicit dtypes pass through."""
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    if compute_dtype == "auto":
        dev = resolve_device(device)
        return torch.bfloat16 if dev.type == "cuda" else torch.float32
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of "
                         f"auto, {', '.join(_DTYPES)}")
    return _DTYPES[compute_dtype]


# exact_float32: one save/restore of the process-wide TF32 switches for
# all overlapping users (filters on several pipeline threads)
_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved: Optional[Tuple[bool, bool]] = None


@contextlib.contextmanager
def exact_float32():
    """cuDNN convolutions and CUDA matmuls in full float32 inside, whatever
    the process-wide TF32 switches say (PyTorch lets cuDNN use TF32 by
    default, ~1e-3 relative). The switches are restored when the last
    overlapping user leaves."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2 standard
    deviations, scaled so that the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=gen)


class ConvBnRelu(nn.Module):
    """Conv (SAME padding, no bias) → BN as scale + bias → relu6. A
    depthwise conv (``groups == in_ch``) is the same grouped convolution
    with weight (features, 1, kh, kw); nnstreamer_tpu stores it as
    ``depthwise_kernel`` (kh, kw, 1, features)."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3), strides: int = 1,
                 groups: int = 1, dilation: int = 1, act: bool = True):
        super().__init__()
        self.strides, self.groups = strides, groups
        self.dilation, self.act = dilation, act
        kh, kw = kernel
        self.weight = nn.Parameter(
            torch.empty(features, in_ch // groups, kh, kw), requires_grad=False)
        self.bn_scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bn_bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _, cin, kh, kw = self.weight.shape
        lecun_normal_(self.weight, cin * kh * kw, gen)
        with torch.no_grad():
            self.bn_scale.fill_(1.0)
            self.bn_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, d = (self.strides,) * 2, (self.dilation,) * 2
        x = conv2d_same(x, self.weight, s, d, self.groups)
        x = x * self.bn_scale[:, None, None] + self.bn_bias[:, None, None]
        return F.relu6(x) if self.act else x


class Conv(nn.Module):
    """flax's ``nn.Conv`` as the zoo's heads use it: SAME padding, stride 1,
    with a bias (lecun_normal kernel, zero bias)."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3)):
        super().__init__()
        kh, kw = kernel
        self.weight = nn.Parameter(torch.empty(features, in_ch, kh, kw),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _, cin, kh, kw = self.weight.shape
        lecun_normal_(self.weight, cin * kh * kw, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (conv2d_same(x, self.weight, (1, 1), (1, 1))
                + self.bias[:, None, None])


class InvertedResidual(nn.Module):
    """MobileNet-v2 block: 1x1 expand (unless ``expand == 1``) → 3x3
    depthwise → 1x1 linear projection, plus the input when the stride is
    1 and the widths agree."""

    def __init__(self, in_ch: int, features: int, strides: int, expand: int,
                 dilation: int = 1):
        super().__init__()
        hidden = in_ch * expand
        self.expand = (ConvBnRelu(in_ch, hidden, (1, 1))
                       if expand != 1 else None)
        self.dw = ConvBnRelu(hidden, hidden, (3, 3), strides=strides,
                             groups=hidden, dilation=dilation)
        self.project = ConvBnRelu(hidden, features, (1, 1), act=False)
        self.residual = strides == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand(x) if self.expand is not None else x
        h = self.project(self.dw(h))
        return h + x if self.residual else h


def place_model(model: nn.Module, compute_dtype, device, seed: int,
                params, convert) -> nn.Module:
    """A zoo model on ``device`` (None = the card) in eval mode, weights in
    the compute dtype: random from ``seed``, or ``params``, nnstreamer_tpu's
    flax tree as numpy arrays, mapped by ``convert`` (models/convert.py).
    Random weights follow flax's initializers (lecun_normal kernels, BN
    scale ones, biases zeros), drawn in module order from a CPU
    ``torch.Generator``, so the card and the CPU get the same weights."""
    dev = resolve_device(device)
    dtype = resolve_compute_dtype(compute_dtype, dev)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        for m in model.modules():
            if isinstance(m, (ConvBnRelu, Conv)):
                m.reset_parameters(gen)
            elif isinstance(m, nn.Linear):
                lecun_normal_(m.weight, m.in_features, gen)
                with torch.no_grad():
                    m.bias.zero_()
    else:
        model.load_state_dict(convert(params, "cpu"))
    model.to(device=dev, dtype=dtype, memory_format=torch.channels_last)
    return model.eval()


def image_input_shape(in_info, name: str) -> Tuple[int, int, int]:
    """(B, H, W) of the one (B, H, W, 3) input a zoo model takes; raises
    ValueError for anything else."""
    specs = in_info.specs
    if len(specs) != 1 or len(specs[0].shape) != 4 or specs[0].shape[3] != 3:
        raise ValueError(f"{name} takes one (B, H, W, 3) tensor, got "
                         f"{in_info.describe()}")
    b, h, w, _ = specs[0].shape
    return b, h, w


class ServedModel:
    """A zoo model as a filter callable: ``call(x)`` under inference mode;
    a float32 build on the card runs without TF32 (``exact_float32``).
    ``output_info`` is the shape rule caps negotiation uses instead of
    running the model. Pure device work: a fused segment may capture it
    in a CUDA graph."""

    capture_safe = True

    def __init__(self, model: nn.Module, call=None, output_info=None):
        self.model = model
        self.dtype = next(model.parameters()).dtype
        self.exact = self.dtype is torch.float32
        self._call = call or model
        self._info = output_info or model.output_info

    def output_info(self, in_info):
        return self._info(in_info)

    def __call__(self, x: torch.Tensor):
        with torch.inference_mode():
            if self.exact and x.is_cuda:
                with exact_float32():
                    return self._call(x)
            return self._call(x)


@dataclass(frozen=True)
class U8Entry:
    """uint8-input filter entry: ``x * (1/127.5) - 1`` in the compute dtype
    ahead of the base entry's callable, so the pipeline ships RAW uint8
    frames to the card — 4× fewer host→device bytes than normalized
    float32. ``make(device)`` as every entry. ``compute_dtype="auto"``
    normalizes in the dtype the base callable computes in (its
    ``dtype``)."""

    base: Any
    compute_dtype: str = "auto"

    def make(self, device=None):
        fn = self.base.make(device)
        dt = (fn.dtype if self.compute_dtype == "auto"
              else resolve_compute_dtype(self.compute_dtype, device))
        return _U8Served(fn, dt)


class _U8Served:
    capture_safe = True

    def __init__(self, fn, dtype: torch.dtype):
        self.fn, self.dtype = fn, dtype

    def output_info(self, in_info):
        return self.fn.output_info(in_info)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x.to(self.dtype) * (1.0 / 127.5) - 1.0)


def make_u8_entry(base_entry, compute_dtype: str = "auto") -> U8Entry:
    """One definition for every model family's ``filter_model_u8``."""
    return U8Entry(base_entry, compute_dtype)
