"""tflite flatbuffer → PyTorch importer: run ``.tflite`` model files on the card.

The counterpart of nnstreamer_tpu's ``models/tflite_import.py``. The
reference runs ``.tflite`` files through the tflite interpreter
(``ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc``); here
the flatbuffer is parsed by the package's own schema reader
(``tflite_schema.py``, no TensorFlow), weights are dequantized to float32
and moved to the model's device once, at load, and the graph runs as a
plain function of torch tensors in native NHWC layout. Quantized models run
as float simulations of the integer graph: weights and inputs dequantized by
their recorded (scale, zero_point), every activation fake-quantized to its
tensor's grid (rounding half to even + saturation — in quantized graphs the
activation clamp lives in the output tensor's quantization range, not the
fused-activation field), outputs re-quantized to the declared output dtype
by default.

``precision:highest`` (the default) runs every convolution and matrix
product as a float64 GEMM rounded to float32: at least full float32
precision, and untouched by PyTorch's process-wide TF32 switches, which
the importer neither reads nor sets. The convs listed in
``FMA_ORDERS`` (by batch, spatial size and shape) instead sum in
XLA:CPU's own order, chains of float32 FMAs over K (``ops/fma_gemm.py``),
which gives the reference's float32 conv bit for bit there. ``high`` runs them in float32 as the
process's switches have it; ``default`` in bfloat16. Depthwise
convolutions and pools are elementwise float32 multiply-adds in the
reference's order; in fake-quant mode the depthwise convs listed in
``DEPTHWISE_FMA_SHAPES`` contract them into fused multiply-adds as
XLA:CPU does under ``jit`` (``ops/depthwise_fma.py``), at every
precision.

The flatbuffer is parsed once at load: op options and weights are copied
into plain Python/numpy structures, so the returned callable holds no
reference to the model bytes.

Supported builtin ops — the reference zoo set (mobilenet_v2_1.0_224_quant,
deeplabv3_257_mv_gpu, add, simple_32): CONV_2D, DEPTHWISE_CONV_2D,
FULLY_CONNECTED, ADD, SUB, MUL, DIV, PAD, AVERAGE_POOL_2D, MAX_POOL_2D,
MEAN, RESHAPE, SOFTMAX, RESIZE_BILINEAR, CONCATENATION, RELU, RELU6,
LOGISTIC, TANH, DEQUANTIZE, QUANTIZE — plus the detection/post-process
vocabulary: STRIDED_SLICE, TRANSPOSE_CONV, SPLIT, SPLIT_V, PACK, UNPACK,
CAST, SQUEEZE, EXPAND_DIMS, SLICE, GATHER, ARG_MAX, SUM, REDUCE_MAX/MIN,
EXP, RSQRT, SQRT, NEG, ABS, POW, SQUARED_DIFFERENCE, LEAKY_RELU,
HARD_SWISH, PRELU, L2_NORMALIZATION, RESIZE_NEAREST_NEIGHBOR,
SPACE_TO_DEPTH, DEPTH_TO_SPACE, MAXIMUM, MINIMUM, SHAPE, TRANSPOSE,
BROADCAST_ARGS, BROADCAST_TO.

It also keeps the two helpers the model zoo's blocks use:
:func:`conv2d_same` and :func:`depthwise_conv` (NCHW).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import DataType, TensorsInfo
from ..core.tensors import TensorSpec
from ..ops.depthwise_fma import depthwise_fma
from ..ops.fma_gemm import fma_gemm, fmaf
from ..utils.hw_accel import resolve_device
from . import tflite_schema

# tflite schema enums (named here so the importer reads like the spec)
_PAD_SAME, _PAD_VALID = 0, 1
_ACT_NONE, _ACT_RELU, _ACT_RELU_N1_1, _ACT_RELU6, _ACT_TANH = 0, 1, 2, 3, 4

_TENSOR_TYPE_NP = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64,
}

# the dtype a value of each numpy type takes in the executors: 64-bit types
# compute as their 32-bit ones, as in nnstreamer_tpu
_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int64): torch.int32, np.dtype(np.bool_): torch.bool,
    np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
    np.dtype(np.float64): torch.float32,
}

_PRECISIONS = ("highest", "high", "default")


def torch_dtype(dt) -> torch.dtype:
    return _TORCH_DTYPE[np.dtype(dt)]


class _Tensor:
    """One tflite tensor's metadata (+ constant data, dropped after load)."""

    def __init__(self, t: tflite_schema.Tensor, buffers):
        self.shape = tuple(int(x) for x in t.shape)
        self.dtype = _TENSOR_TYPE_NP[t.type]
        q = t.quantization
        self.scale = self.zero_point = None
        self.quant_dim = 0
        if q is not None and q.scale.size:
            self.scale = q.scale.astype(np.float32)
            self.zero_point = (
                q.zero_point.astype(np.int64)
                if q.zero_point.size else np.zeros_like(self.scale, np.int64)
            )
            self.quant_dim = int(q.quantized_dimension)
        buf = buffers[t.buffer]
        self.data: Optional[np.ndarray] = None
        if buf is not None and getattr(buf, "size", 0):
            self.data = np.frombuffer(buf.tobytes(), self.dtype).reshape(self.shape)

    @property
    def quantized(self) -> bool:
        return self.scale is not None and self.dtype in (np.uint8, np.int8, np.int32)

    def dequantized(self) -> np.ndarray:
        """Weight data as float32 (per-tensor or per-channel)."""
        a = self.data
        if a is None:
            raise ValueError("tensor has no constant data")
        if not self.quantized:
            return a.astype(np.float32)
        scale, zp = self.scale, self.zero_point
        if scale.size > 1:  # per-channel: broadcast along quant_dim
            bshape = [1] * a.ndim
            bshape[self.quant_dim] = scale.size
            scale = scale.reshape(bshape)
            zp = zp.reshape(bshape)
        return (a.astype(np.float32) - zp) * scale


def _fused(act: int, x):
    if act == _ACT_NONE:
        return x
    if act == _ACT_RELU:
        return torch.clamp(x, min=0.0)
    if act == _ACT_RELU_N1_1:
        return torch.clamp(x, -1.0, 1.0)
    if act == _ACT_RELU6:
        return torch.clamp(x, 0.0, 6.0)
    if act == _ACT_TANH:
        return torch.tanh(x)
    raise NotImplementedError(f"tflite fused activation {act}")


def _conv_padding(mode: int) -> str:
    return "SAME" if mode == _PAD_SAME else "VALID"


def explicit_padding(h: int, w: int, kh: int, kw: int, strides, dilation,
                     padding: str):
    """tflite ComputePadding: (out_h, out_w, ((top, bottom), (left, right)))
    — SAME splits the total with the extra row/col at the END (the TF/XLA
    convention; torch's symmetric ``padding=`` would shift every stride-2
    layer by one pixel)."""
    sh, sw = strides
    dh, dw = dilation
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        pt = max((oh - 1) * sh + ekh - h, 0)
        pl = max((ow - 1) * sw + ekw - w, 0)
        return oh, ow, ((pt // 2, pt - pt // 2), (pl // 2, pl - pl // 2))
    oh, ow = (h - ekh) // sh + 1, (w - ekw) // sw + 1
    return oh, ow, ((0, 0), (0, 0))


def conv2d_same(x: torch.Tensor, w: torch.Tensor, strides, dilation,
                groups: int = 1, padding: str = "SAME") -> torch.Tensor:
    """``F.conv2d`` of an NCHW (or channels_last) ``x`` with the TF padding
    of :func:`explicit_padding`: symmetric padding goes to the convolution
    itself, asymmetric padding is applied first with ``F.pad``."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    _, _, ((pt, pb), (pl, pr)) = explicit_padding(
        int(x.shape[2]), int(x.shape[3]), kh, kw, strides, dilation, padding)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, None, strides, (pt, pl), dilation, groups)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, None, strides, 0, dilation, groups)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, strides, padding: str,
                   dilation) -> torch.Tensor:
    """Depthwise convolution with the meaning of :func:`depthwise_shift_add`:
    output channel ``o`` is input channel ``o // mult`` (tflite's c*mult + m
    order) weighted by ``w[o, 0]``.

    ``x`` is (N, C, H, W); ``w`` is (C*mult, 1, kh, kw) — tflite's
    [1, kh, kw, C*mult] is ``w.permute(3, 0, 1, 2)`` of it."""
    return conv2d_same(x, w, strides, dilation, groups=int(x.shape[1]),
                       padding=padding)


def pad_nhwc(x: torch.Tensor, pads, value=0) -> torch.Tensor:
    """Pad the H and W axes of an NHWC tensor by ((top, bottom), (left,
    right)) with ``value``."""
    (pt, pb), (pl, pr) = pads
    if not (pt or pb or pl or pr):
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def window_taps(xp: torch.Tensor, kh: int, kw: int, oh: int, ow: int,
                strides, dilation=(1, 1)):
    """The kh*kw strided (N, oh, ow, C) views of a padded NHWC tensor, in
    (ky, kx) order: tap (ky, kx) of output (i, j) is input
    (i*sh + ky*dh, j*sw + kx*dw)."""
    sh, sw = strides
    dh, dw = dilation
    return [xp[:, ky * dh:ky * dh + sh * (oh - 1) + 1:sh,
               kx * dw:kx * dw + sw * (ow - 1) + 1:sw, :]
            for ky in range(kh) for kx in range(kw)]


def depthwise_shift_add(x, w, strides, padding: str, dilation):
    """Depthwise conv as kh*kw shifted elementwise multiply-adds, summed in
    (ky, kx) order as nnstreamer_tpu does.

    ``x`` is NHWC; ``w`` is the raw tflite layout [1, kh, kw, C*mult];
    multiplier > 1 is handled by repeating input channels (tflite output
    channel order is c*mult + m).
    """
    kh, kw, oc = int(w.shape[1]), int(w.shape[2]), int(w.shape[3])
    n, h, wd, c = x.shape
    oh, ow, pads = explicit_padding(h, wd, kh, kw, strides, dilation, padding)
    xp = pad_nhwc(x, pads)
    if oc != c:  # channel multiplier
        xp = torch.repeat_interleave(xp, oc // c, dim=-1)
    acc = None
    for k, sl in enumerate(window_taps(xp, kh, kw, oh, ow, strides,
                                       dilation)):
        term = sl * w[0, k // kw, k % kw, :]
        acc = term if acc is None else acc + term
    return acc


def _window_reduce(x, kh: int, kw: int, strides, padding: str, pad_value,
                   op):
    oh, ow, pads = explicit_padding(int(x.shape[1]), int(x.shape[2]), kh, kw,
                                    strides, (1, 1), padding)
    acc = None
    for sl in window_taps(pad_nhwc(x, pads, pad_value), kh, kw, oh, ow,
                          strides):
        acc = sl if acc is None else op(acc, sl)
    return acc


def _pool(x, kind: str, cfg: dict):
    """AVERAGE/MAX pool over kh*kw shifted views; SAME average pooling
    divides by the per-window valid-element count (tflite semantics)."""
    kh, kw = cfg["filter"]
    pad = cfg["padding"]
    if kind == "max":
        return _window_reduce(x, kh, kw, cfg["strides"], pad, -float("inf"),
                              torch.maximum)
    total = _window_reduce(x, kh, kw, cfg["strides"], pad, 0.0, torch.add)
    return total / pool_counts(x, kh, kw, cfg["strides"], pad)


def pool_counts(x, kh: int, kw: int, strides, padding: str):
    """Per-window count of valid elements, (1, oh, ow, 1) float32 on x's
    device (a scalar tensor for VALID padding)."""
    if padding == "VALID":
        return torch.full((), float(kh * kw), dtype=torch.float32,
                          device=x.device)
    ones = torch.ones((1, int(x.shape[1]), int(x.shape[2]), 1),
                      dtype=torch.float32, device=x.device)
    return _window_reduce(ones, kh, kw, strides, padding, 0.0, torch.add)


def _resize_bilinear(x, out_hw, align_corners: bool, half_pixel: bool):
    n, ih, iw, c = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    dev = x.device

    def coords(out_n, in_n):
        i = torch.arange(out_n, dtype=torch.float32, device=dev)
        if align_corners and out_n > 1:
            return i * (in_n - 1) / (out_n - 1)
        if half_pixel:
            return torch.clamp((i + 0.5) * in_n / out_n - 0.5, 0.0, in_n - 1.0)
        return torch.clamp(i * in_n / out_n, 0.0, in_n - 1.0)

    ys, xs = coords(oh, ih), coords(ow, iw)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=ih - 1)
    x1 = torch.clamp(x0 + 1, max=iw - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]

    def g(yi, xi):  # gather rows then cols
        return x[:, yi][:, :, xi]

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _resize_nearest(x, out_hw, align_corners: bool, half_pixel: bool):
    """tflite RESIZE_NEAREST_NEIGHBOR index rule (reference kernel
    reference_ops::ResizeNearestNeighbor): scale = (in-1)/(out-1) with
    align-corners else in/out; half-pixel adds 0.5 to the output index
    before scaling; align-corners rounds half AWAY from zero
    (TfLiteRound — coords are nonnegative, so floor(v+0.5)), else floor."""
    _, ih, iw, _ = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    dev = x.device

    def idx(out_n, in_n):
        i = torch.arange(out_n, dtype=torch.float32, device=dev)
        scale = ((in_n - 1) / (out_n - 1)
                 if align_corners and out_n > 1 else in_n / out_n)
        v = (i + (0.5 if half_pixel else 0.0)) * scale
        j = torch.floor(v + 0.5) if align_corners else torch.floor(v)
        return torch.clamp(j, 0, in_n - 1).to(torch.int64)

    return x[:, idx(oh, ih)][:, :, idx(ow, iw)]


def _parse_step(code: str, op: tflite_schema.Operator,
                tensors: List[_Tensor]) -> dict:
    """Extract everything an op needs into a plain dict, so execution never
    touches flatbuffer schema objects (and the model bytes can be freed)."""
    cfg: Dict[str, Any] = {}
    if code in ("CONV_2D", "DEPTHWISE_CONV_2D"):
        o = op.options("Conv2DOptions" if code == "CONV_2D"
                       else "DepthwiseConv2DOptions")
        cfg = {
            "strides": (o["stride_h"], o["stride_w"]),
            "padding": _conv_padding(o["padding"]),
            "dilation": (o["dilation_h_factor"], o["dilation_w_factor"]),
            "act": o["fused_activation_function"],
        }
    elif code == "FULLY_CONNECTED":
        o = op.options("FullyConnectedOptions")
        cfg = {"act": o["fused_activation_function"]}
    elif code in ("ADD", "SUB", "MUL", "DIV"):
        o = op.options({"ADD": "AddOptions", "SUB": "SubOptions",
                        "MUL": "MulOptions", "DIV": "DivOptions"}[code])
        cfg = {"act": o["fused_activation_function"] if o is not None
               else _ACT_NONE}
    elif code in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
        o = op.options("Pool2DOptions")
        cfg = {
            "filter": (o["filter_height"], o["filter_width"]),
            "strides": (o["stride_h"], o["stride_w"]),
            "padding": _conv_padding(o["padding"]),
            "act": o["fused_activation_function"],
        }
    elif code == "MEAN":
        o = op.options("ReducerOptions")
        cfg = {"keepdims": bool(o["keep_dims"])}
    elif code == "RESHAPE":
        o = op.options("ReshapeOptions")
        if o is not None and o["new_shape"].size:
            cfg = {"new_shape": [int(v) for v in o["new_shape"]]}
    elif code == "SOFTMAX":
        o = op.options("SoftmaxOptions")
        cfg = {"beta": o["beta"] if o is not None else 1.0}
    elif code == "CONCATENATION":
        o = op.options("ConcatenationOptions")
        cfg = {"axis": o["axis"], "act": o["fused_activation_function"]}
    elif code == "RESIZE_BILINEAR":
        o = op.options("ResizeBilinearOptions")
        cfg = {"align_corners": bool(o["align_corners"]),
               "half_pixel": bool(o["half_pixel_centers"])}
    elif code == "RESIZE_NEAREST_NEIGHBOR":
        o = op.options("ResizeNearestNeighborOptions")
        cfg = {"align_corners": bool(o["align_corners"]) if o else False,
               "half_pixel": bool(o["half_pixel_centers"]) if o else False}
    elif code == "STRIDED_SLICE":
        o = op.options("StridedSliceOptions")
        cfg = {k: o[k] for k in ("begin_mask", "end_mask", "ellipsis_mask",
                                 "new_axis_mask", "shrink_axis_mask")}
    elif code == "TRANSPOSE_CONV":
        o = op.options("TransposeConvOptions")
        cfg = {"strides": (o["stride_h"], o["stride_w"]),
               "padding": _conv_padding(o["padding"]),
               "act": o["fused_activation_function"]}
    elif code == "SPLIT":
        o = op.options("SplitOptions")
        cfg = {"num": o["num_splits"]}
    elif code == "PACK":
        o = op.options("PackOptions")
        cfg = {"axis": o["axis"]}
    elif code == "UNPACK":
        o = op.options("UnpackOptions")
        cfg = {"axis": o["axis"], "num": o["num"]}
    elif code == "SQUEEZE":
        o = op.options("SqueezeOptions")
        cfg = {"dims": [int(v) for v in o["squeeze_dims"]]
               if o is not None and o["squeeze_dims"].size else []}
    elif code == "GATHER":
        o = op.options("GatherOptions")
        cfg = {"axis": o["axis"] if o is not None else 0,
               "batch_dims": int(o["batch_dims"]) if o is not None else 0}
    elif code in ("SUM", "REDUCE_MAX", "REDUCE_MIN"):
        o = op.options("ReducerOptions")
        cfg = {"keepdims": bool(o["keep_dims"]) if o is not None else False}
    elif code == "LEAKY_RELU":
        o = op.options("LeakyReluOptions")
        cfg = {"alpha": float(o["alpha"]) if o is not None else 0.2}
    elif code in ("SPACE_TO_DEPTH", "DEPTH_TO_SPACE"):
        o = op.options("SpaceToDepthOptions" if code == "SPACE_TO_DEPTH"
                       else "DepthToSpaceOptions")
        cfg = {"block": int(o["block_size"])}
    return cfg


class ScalarCache:
    """0-dim float32 tensors on one device, made on first use. Dividing a
    CUDA tensor by a Python number multiplies by its reciprocal (PyTorch's
    CPU-scalar shortcut), which is not the quotient; dividing by a device
    tensor is.

    ``recip(v)`` is ``float32(1) / float32(v)`` as such a tensor: XLA's
    algebraic simplifier rewrites ``y / constant`` into ``y *
    (1 / constant)``, the reciprocal rounded to float32, and the jitted
    reference's fake-quant snaps (``round(y / scale)``) run as that
    product."""

    def __init__(self, device: torch.device):
        self.device = device
        self._made: Dict[float, torch.Tensor] = {}

    def prefill(self, steps, tensors, raw_consts) -> None:
        """Make now every divisor the executors use (each quantized
        tensor's scale, each MEAN's recorded count, 6), so a CUDA graph
        capture of a first call allocates none of them."""
        for t in tensors:
            if t.scale is not None:
                self(float(t.scale[0]))
                self.recip(float(t.scale[0]))
        self(6.0)
        for code, _, ins, _ in steps:
            if code == "MEAN" and ins[1] in raw_consts:
                shape = tensors[ins[0]].shape
                axes = np.atleast_1d(raw_consts[ins[1]]).reshape(-1)
                if all(-len(shape) <= int(a) < len(shape) for a in axes):
                    self(float(np.prod([shape[int(a)] for a in axes])))

    def __call__(self, v: float) -> torch.Tensor:
        t = self._made.get(v)
        if t is None:
            t = self._made[v] = torch.full((), v, dtype=torch.float32,
                                           device=self.device)
        return t

    def recip(self, v: float) -> torch.Tensor:
        return self(float(np.float32(1.0) / np.float32(v)))


# (batch, in_h, in_w, kh, kw, stride_h, stride_w, in_c, out_c) of the CONV_2D
# ops at which the reference's precision=HIGHEST float32 conv on XLA:CPU
# equals float32 FMA chains over K in HWIO order bit for bit, with the
# order XLA uses there as (chains, kblock) (FMA_ORDERS; ops/fma_gemm.py:
# one chain, 2 or 4 interleaved chains summed pairwise, or a chain a block
# of kblock steps, the blocks summed in order): convs of the int8
# MobileNet-v2 fixture at batches 1, 4 and 64, each held against the
# reference by a case of tests/test_torch_tflite_fma.py. XLA's order
# depends on the size of the product (at batch 1 the fixture's 1x1 convs
# at 7x7 sum in other orders), so nothing else is assumed: every other
# conv, batch and spatial size keeps the float64 GEMM.
_FMA_CONVS = {  # (in_hw, kh, kw, stride_h, stride_w, in_c, out_c): order
    (224, 3, 3, 2, 2, 3, 32): (1, 0), (28, 1, 1, 1, 1, 32, 192): (1, 0),
    (14, 1, 1, 1, 1, 192, 64): (1, 0), (14, 1, 1, 1, 1, 64, 384): (1, 0),
    (14, 1, 1, 1, 1, 384, 64): (1, 0), (14, 1, 1, 1, 1, 96, 576): (1, 0),
    (7, 1, 1, 1, 1, 160, 960): (1, 0), (7, 1, 1, 1, 1, 320, 1280): (1, 0),
    (112, 1, 1, 1, 1, 16, 96): (2, 0), (28, 1, 1, 1, 1, 144, 32): (2, 0),
    (28, 1, 1, 1, 1, 192, 32): (2, 0), (14, 1, 1, 1, 1, 384, 96): (2, 0),
    (14, 1, 1, 1, 1, 576, 96): (2, 0), (7, 1, 1, 1, 1, 576, 160): (2, 0),
    (7, 1, 1, 1, 1, 960, 160): (2, 0),
    (112, 1, 1, 1, 1, 32, 16): (4, 0), (56, 1, 1, 1, 1, 24, 144): (4, 0),
    (56, 1, 1, 1, 1, 96, 24): (4, 0), (56, 1, 1, 1, 1, 144, 24): (4, 0),
    (7, 1, 1, 1, 1, 960, 320): (1, 512)}
FMA_ORDERS = {(batch, hw, hw, *conv): order
              for (hw, *conv), order in _FMA_CONVS.items()
              for batch in (1, 4, 64) if (batch, hw) != (1, 7)}


# (batch, in_h, in_w, kh, kw, stride_h, stride_w, in_c, out_c) of the
# DEPTHWISE_CONV_2D ops at which the reference's jitted depthwise_shift_add
# on XLA:CPU, fed a fake-quantized input, equals ops/depthwise_fma.py's FMA
# chain bit for bit: the fixture's depthwise convs (all 3x3, SAME,
# undilated) at batches 1, 4 and 64, each held by a case of
# tests/test_torch_tflite_dw_fma.py. Nothing else is assumed.
_FMA_DEPTHWISE = (  # (in_hw, stride, channels)
    (112, 1, 32), (112, 2, 96), (56, 1, 144), (56, 2, 144), (28, 1, 192),
    (28, 2, 192), (14, 1, 384), (14, 1, 576), (14, 2, 576), (7, 1, 960))
DEPTHWISE_FMA_SHAPES = frozenset(
    (batch, hw, hw, 3, 3, s, s, c, c) for hw, s, c in _FMA_DEPTHWISE
    for batch in (1, 4, 64))


def _depthwise(x, w, strides, padding: str, dilation,
               in_scale: Optional[float]):
    """The graph's DEPTHWISE_CONV_2D: XLA:CPU's FMA order at the listed
    shapes of a fake-quantized input of scale ``in_scale``, the reference's
    unfused order elsewhere."""
    n, h, wd, c = (int(d) for d in x.shape)
    kh, kw, oc = (int(d) for d in w.shape[1:])
    if in_scale is not None and padding == "SAME" and \
            tuple(dilation) == (1, 1) and (n, h, wd, kh, kw, *strides, c,
                                           oc) in DEPTHWISE_FMA_SHAPES:
        oh, ow, pads = explicit_padding(h, wd, kh, kw, strides, dilation,
                                        padding)
        return depthwise_fma(x, w, strides, dilation, pads, (oh, ow),
                             in_scale)
    return depthwise_shift_add(x, w, strides, padding, dilation)


def _gemm_float(precision: str):
    """``(a, b) -> a @ b`` for float32 ``a`` (..., K) and ``b`` (K, N) at
    the chosen precision (module docstring)."""
    if precision == "highest":
        return lambda a, b: torch.matmul(a.double(), b.double()).float()
    if precision == "default":
        return lambda a, b: torch.matmul(a.bfloat16(), b.bfloat16()).float()
    return torch.matmul


def im2col(x, kh: int, kw: int, strides, dilation, padding: str, pad_value):
    """NHWC patches (N, oh, ow, kh*kw*C), K ordered (ky, kx, c)."""
    n, h, w, c = x.shape
    oh, ow, pads = explicit_padding(h, w, kh, kw, strides, dilation, padding)
    cols = window_taps(pad_nhwc(x, pads, pad_value), kh, kw, oh, ow, strides,
                       dilation)
    return torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]


def _as_torch(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def build_float_fn(steps, tensors: List[_Tensor], consts: Dict[int, np.ndarray],
                   raw_consts: Dict[int, np.ndarray], in_idx: List[int],
                   out_idx: List[int], q_exec: str, float_output: bool,
                   batch_mode: bool, precision: str, device: torch.device):
    """The fake-quant / float executor: ``fn(*inputs) -> tuple`` on
    ``device``, with the dequantized constants moved there now."""
    meta = device.type == "meta"
    dev_consts: Dict[int, torch.Tensor] = {}
    for idx, a in consts.items():
        dt = torch_dtype(a.dtype)
        if meta:
            dev_consts[idx] = torch.empty(a.shape, dtype=dt, device=device)
        else:
            dev_consts[idx] = torch.from_numpy(
                np.ascontiguousarray(a)).to(dt).to(device)
    # convs as GEMMs: OHWI weights → (kh*kw*ic, oc) once
    conv_w: Dict[int, torch.Tensor] = {}
    for code, cfg, ins, outs in steps:
        if code == "CONV_2D" and ins[1] in dev_consts:
            w = dev_consts[ins[1]]
            oc = int(w.shape[0])
            conv_w[ins[1]] = w.permute(1, 2, 3, 0).reshape(-1, oc).contiguous()
        elif code == "FULLY_CONNECTED" and ins[1] in dev_consts:
            conv_w[ins[1]] = dev_consts[ins[1]].t().contiguous()
    gemm = _gemm_float(precision)
    sc = ScalarCache(device)
    sc.prefill(steps, tensors, raw_consts)

    def _in(env, idx):
        if idx in env:
            v = env[idx]
            return _as_torch(v, device) if isinstance(v, np.ndarray) else v
        return dev_consts[idx]

    def _fake_quant(idx: int, y):
        """Emulate integer inference on an activation tensor: round to the
        tensor's quantization grid and saturate to its integer range. In
        quantized tflite graphs the activation clamp (e.g. relu6) lives in
        the OUTPUT tensor's quantization range, not the fused-activation
        field — without this, out-of-range values propagate un-saturated
        and the float simulation diverges from the interpreter."""
        t = tensors[idx]
        if not (t.quantized and t.dtype in (np.uint8, np.int8)):
            return y
        if not isinstance(y, torch.Tensor) or not y.is_floating_point():
            return y
        scale, zp = float(t.scale[0]), float(t.zero_point[0])
        info = np.iinfo(t.dtype)
        if q_exec == "float":
            # no grid rounding, but the RANGE clamp must stay: quantized
            # graphs encode fused activations (relu6 etc.) solely in the
            # tensor's representable range — dropping it changes the net
            return torch.clamp(y, (info.min - zp) * scale,
                               (info.max - zp) * scale)
        q = torch.clamp(torch.round(y * sc.recip(scale)) + zp, info.min,
                        info.max)
        return (q - zp) * scale

    def _fq_scale(idx: int) -> Optional[float]:
        """The scale of tensor ``idx`` where fake-quant snapped it to its
        grid (``float32(k * scale)``), else None."""
        t = tensors[idx]
        if q_exec != "fake-quant" or idx in consts or not (
                t.quantized and t.dtype in (np.uint8, np.int8)):
            return None
        return float(t.scale[0])

    def _const(idx) -> np.ndarray:
        """Operand that must be statically known at trace time (shapes,
        axes, pads) — raw integer values, not dequantized."""
        if idx not in raw_consts:
            raise NotImplementedError(
                f"tflite import: dynamic (non-const) shape operand tensor {idx}"
            )
        return raw_consts[idx]

    def _shape_operand(env, idx) -> np.ndarray:
        v = env.get(idx)
        if isinstance(v, np.ndarray):
            return v
        if v is not None:
            raise NotImplementedError(
                "tflite import: shape operand computed on the device")
        return np.asarray(_const(idx))

    def _conv(env, x, idx_w, cfg):
        w = _in(env, idx_w)
        oc, kh, kw, ic = (int(d) for d in w.shape)
        if kh == kw == 1 and tuple(cfg["strides"]) == (1, 1):
            p = x
        else:
            p = im2col(x, kh, kw, cfg["strides"], cfg["dilation"],
                       cfg["padding"], 0.0)
        w_mat = conv_w.get(idx_w)
        if w_mat is None:  # weights computed in the graph
            w_mat = w.permute(1, 2, 3, 0).reshape(-1, oc)
        order = FMA_ORDERS.get(
            (*x.shape[:3], kh, kw, *cfg["strides"], ic, oc))
        if precision == "highest" and order:
            return fma_gemm(p, w_mat, *order)
        return gemm(p, w_mat)

    def fn(*inputs):
        env: Dict[int, Any] = {}
        for i, idx in enumerate(in_idx):
            t = tensors[idx]
            x = _as_torch(inputs[i], device)
            if t.quantized and not x.is_floating_point():
                x = (x.to(torch.float32) - float(t.zero_point[0])) * float(t.scale[0])
            elif x.dtype != torch.float32 and x.is_floating_point():
                x = x.to(torch.float32)
            env[idx] = x

        for code, cfg, ins, outs in steps:
            if code == "CONV_2D":
                y = _conv(env, _in(env, ins[0]), ins[1], cfg)
                if len(ins) > 2 and ins[2] >= 0:
                    y = y + _in(env, ins[2])
                env[outs[0]] = _fused(cfg["act"], y)
            elif code == "DEPTHWISE_CONV_2D":
                x, w = _in(env, ins[0]), _in(env, ins[1])
                y = _depthwise(
                    x, w, cfg["strides"], cfg["padding"], cfg["dilation"],
                    _fq_scale(ins[0]))
                if len(ins) > 2 and ins[2] >= 0:
                    y = y + _in(env, ins[2])
                env[outs[0]] = _fused(cfg["act"], y)
            elif code == "FULLY_CONNECTED":
                x = _in(env, ins[0])
                w = conv_w.get(ins[1])
                if w is None:
                    w = _in(env, ins[1]).t()
                y = gemm(x.reshape(x.shape[0], -1), w)
                if len(ins) > 2 and ins[2] >= 0:
                    y = y + _in(env, ins[2])
                env[outs[0]] = _fused(cfg["act"], y)
            elif code in ("ADD", "SUB", "MUL", "DIV"):
                a, b = _in(env, ins[0]), _in(env, ins[1])
                sa = _fq_scale(ins[0])
                if code == "ADD" and sa is not None and \
                        _fq_scale(ins[1]) is not None:
                    # XLA contracts the first operand's dequantizing
                    # multiply into the add: fmaf(k_a, s_a, b), with k_a
                    # = q_a - zp_a recovered exactly from a = k_a * s_a
                    y = fmaf(torch.round(a * sc.recip(sa)),
                             float(np.float32(sa)), b)
                elif code == "ADD":
                    y = a + b
                elif code == "SUB":
                    y = a - b
                elif code == "MUL":
                    y = a * b
                else:
                    y = a / b
                env[outs[0]] = _fused(cfg["act"], y)
            elif code == "AVERAGE_POOL_2D":
                env[outs[0]] = _fused(cfg["act"], _pool(_in(env, ins[0]), "avg", cfg))
            elif code == "MAX_POOL_2D":
                env[outs[0]] = _fused(cfg["act"], _pool(_in(env, ins[0]), "max", cfg))
            elif code == "MEAN":
                axes = tuple(int(a) for a in np.atleast_1d(_const(ins[1])))
                x = _in(env, ins[0])
                n = int(np.prod([x.shape[a] for a in axes]))
                env[outs[0]] = x.sum(dim=axes, keepdim=cfg["keepdims"]) / sc(
                    float(n))
            elif code == "PAD":
                pads = np.asarray(_const(ins[1])).reshape(-1, 2)
                flat = [int(v) for p in pads[::-1] for v in p]
                env[outs[0]] = F.pad(_in(env, ins[0]), flat)
            elif code == "RESHAPE":
                x = _in(env, ins[0])
                if "new_shape" in cfg:
                    shape = list(cfg["new_shape"])
                else:
                    shape = [int(v) for v in _shape_operand(env, ins[1]).reshape(-1)]
                # batch-polymorphism: rewrite a recorded batch-1 leading
                # dim to the runtime batch when (a) the recorded shape
                # cannot hold the actual element count, or (b) under a
                # DECLARED batch option, the shape carries a -1
                # ([1, -1]-style flatten heads: folding the batch into the
                # -1 axis would interleave frames). Without the batch
                # option a [1,-1] reshape of a leading-dim>1 tensor stays
                # a genuine flatten-all, matching the interpreter.
                if shape and shape[0] == 1 and x.shape[0] != 1 and (
                        (batch_mode and -1 in shape)
                        or (-1 not in shape
                            and int(np.prod(shape)) != int(np.prod(x.shape)))):
                    shape[0] = int(x.shape[0])
                env[outs[0]] = x.reshape(shape)
            elif code == "SOFTMAX":
                env[outs[0]] = softmax(_in(env, ins[0]) * cfg["beta"])
            elif code == "CONCATENATION":
                parts = [_in(env, i) for i in ins]
                axis = cfg["axis"] % parts[0].ndim
                env[outs[0]] = _fused(cfg["act"], torch.cat(parts, dim=axis))
            elif code == "RESIZE_BILINEAR":
                out_hw = np.asarray(_const(ins[1])).reshape(-1)
                env[outs[0]] = _resize_bilinear(
                    _in(env, ins[0]), out_hw,
                    cfg["align_corners"], cfg["half_pixel"])
            elif code == "RELU":
                env[outs[0]] = torch.clamp(_in(env, ins[0]), min=0.0)
            elif code == "RELU6":
                env[outs[0]] = torch.clamp(_in(env, ins[0]), 0.0, 6.0)
            elif code == "LOGISTIC":
                env[outs[0]] = torch.sigmoid(_in(env, ins[0]))
            elif code == "TANH":
                env[outs[0]] = torch.tanh(_in(env, ins[0]))
            elif code in ("MAXIMUM", "MINIMUM"):
                op = torch.maximum if code == "MAXIMUM" else torch.minimum
                env[outs[0]] = op(_in(env, ins[0]), _in(env, ins[1]))
            elif code == "SHAPE":
                # static: a CONCRETE numpy constant, so the shape ops
                # below stay host-side
                env[outs[0]] = np.asarray(tuple(_in(env, ins[0]).shape), np.int32)
            elif code == "BROADCAST_ARGS":
                a = _shape_operand(env, ins[0])
                b = _shape_operand(env, ins[1])
                env[outs[0]] = np.asarray(
                    np.broadcast_shapes(tuple(a), tuple(b)), np.int32)
            elif code == "BROADCAST_TO":
                shape = _shape_operand(env, ins[1]).reshape(-1).tolist()
                env[outs[0]] = torch.broadcast_to(_in(env, ins[0]), shape)
            elif code == "TRANSPOSE":
                perm = np.asarray(_const(ins[1])).reshape(-1).tolist()
                env[outs[0]] = _in(env, ins[0]).permute(*perm)
            elif code == "STRIDED_SLICE":
                env[outs[0]] = _strided_slice(_in(env, ins[0]), cfg,
                                              _const(ins[1]), _const(ins[2]),
                                              _const(ins[3]))
            elif code == "TRANSPOSE_CONV":
                out_shape = tuple(int(v) for v in
                                  np.asarray(_const(ins[0])).reshape(-1))
                y = _transpose_conv(_in(env, ins[2]), _in(env, ins[1]),
                                    cfg, out_shape, precision)
                if len(ins) > 3 and ins[3] >= 0:
                    y = y + _in(env, ins[3])
                env[outs[0]] = _fused(cfg["act"], y)
            elif code == "SPLIT":
                axis = int(np.asarray(_const(ins[0])).reshape(-1)[0])
                x = _in(env, ins[1])
                parts = torch.chunk(x, cfg["num"], dim=axis % x.ndim)
                for o_idx, part in zip(outs, parts):
                    env[o_idx] = part
            elif code == "SPLIT_V":
                x = _in(env, ins[0])
                sizes = [int(v) for v in np.asarray(_const(ins[1])).reshape(-1)]
                axis = int(np.asarray(_const(ins[2])).reshape(-1)[0]) % x.ndim
                if sizes.count(-1) == 1:  # one wildcard: infer the remainder
                    sizes[sizes.index(-1)] = (
                        int(x.shape[axis]) - sum(v for v in sizes if v >= 0))
                for o_idx, part in zip(outs, torch.split(x, sizes, dim=axis)):
                    env[o_idx] = part
            elif code == "PACK":
                parts = [_in(env, i) for i in ins]
                env[outs[0]] = torch.stack(
                    parts, dim=cfg["axis"] % (parts[0].ndim + 1))
            elif code == "UNPACK":
                x = _in(env, ins[0])
                for k, o_idx in enumerate(outs):
                    env[o_idx] = torch.select(x, cfg["axis"] % x.ndim, k)
            elif code == "CAST":
                env[outs[0]] = _in(env, ins[0]).to(
                    torch_dtype(tensors[outs[0]].dtype))
            elif code == "SQUEEZE":
                x = _in(env, ins[0])
                dims = cfg["dims"] or [d for d, n in enumerate(x.shape) if n == 1]
                env[outs[0]] = x.squeeze(tuple(d % x.ndim for d in dims))
            elif code == "EXPAND_DIMS":
                x = _in(env, ins[0])
                axis = int(np.asarray(_const(ins[1])).reshape(-1)[0])
                env[outs[0]] = x.unsqueeze(axis % (x.ndim + 1))
            elif code == "SLICE":
                x = _in(env, ins[0])
                begin = np.asarray(_const(ins[1])).reshape(-1)
                size = np.asarray(_const(ins[2])).reshape(-1)
                idx = tuple(
                    slice(int(b), None if int(sz) == -1 else int(b) + int(sz))
                    for b, sz in zip(begin, size))
                env[outs[0]] = x[idx]
            elif code == "GATHER":
                env[outs[0]] = _gather(_in(env, ins[0]), _in(env, ins[1]),
                                       cfg["axis"], cfg["batch_dims"])
            elif code == "ARG_MAX":
                axis = int(np.asarray(_const(ins[1])).reshape(-1)[0])
                env[outs[0]] = torch.argmax(_in(env, ins[0]), dim=axis).to(
                    torch_dtype(tensors[outs[0]].dtype))
            elif code in ("SUM", "REDUCE_MAX", "REDUCE_MIN"):
                axes = tuple(int(a) for a in
                             np.atleast_1d(np.asarray(_const(ins[1]))))
                red = {"SUM": torch.sum, "REDUCE_MAX": torch.amax,
                       "REDUCE_MIN": torch.amin}[code]
                env[outs[0]] = red(_in(env, ins[0]), dim=axes,
                                   keepdim=cfg["keepdims"])
            elif code == "EXP":
                env[outs[0]] = torch.exp(_in(env, ins[0]))
            elif code == "RSQRT":
                env[outs[0]] = torch.rsqrt(_in(env, ins[0]))
            elif code == "SQRT":
                env[outs[0]] = torch.sqrt(_in(env, ins[0]))
            elif code == "NEG":
                env[outs[0]] = -_in(env, ins[0])
            elif code == "ABS":
                env[outs[0]] = torch.abs(_in(env, ins[0]))
            elif code == "POW":
                env[outs[0]] = torch.pow(_in(env, ins[0]), _in(env, ins[1]))
            elif code == "SQUARED_DIFFERENCE":
                d = _in(env, ins[0]) - _in(env, ins[1])
                env[outs[0]] = d * d
            elif code == "LEAKY_RELU":
                x = _in(env, ins[0])
                env[outs[0]] = torch.where(x >= 0, x, cfg["alpha"] * x)
            elif code == "HARD_SWISH":
                x = _in(env, ins[0])
                env[outs[0]] = x * torch.clamp(x + 3.0, 0.0, 6.0) / sc(6.0)
            elif code == "PRELU":
                x, alpha = _in(env, ins[0]), _in(env, ins[1])
                env[outs[0]] = torch.where(x >= 0, x, alpha * x)
            elif code == "L2_NORMALIZATION":
                x = _in(env, ins[0])
                env[outs[0]] = x * torch.rsqrt(torch.clamp(
                    torch.sum(x * x, dim=-1, keepdim=True), min=1e-12))
            elif code == "RESIZE_NEAREST_NEIGHBOR":
                out_hw = np.asarray(_const(ins[1])).reshape(-1)
                env[outs[0]] = _resize_nearest(
                    _in(env, ins[0]), out_hw,
                    cfg["align_corners"], cfg["half_pixel"])
            elif code == "SPACE_TO_DEPTH":
                x = _in(env, ins[0])
                n, h, w2, c = x.shape
                bs = cfg["block"]
                y = x.reshape(n, h // bs, bs, w2 // bs, bs, c)
                env[outs[0]] = y.permute(0, 1, 3, 2, 4, 5).reshape(
                    n, h // bs, w2 // bs, c * bs * bs)
            elif code == "DEPTH_TO_SPACE":
                x = _in(env, ins[0])
                n, h, w2, c = x.shape
                bs = cfg["block"]
                y = x.reshape(n, h, w2, bs, bs, c // (bs * bs))
                env[outs[0]] = y.permute(0, 1, 3, 2, 4, 5).reshape(
                    n, h * bs, w2 * bs, c // (bs * bs))
            elif code in ("DEQUANTIZE", "QUANTIZE"):
                t = tensors[ins[0]]
                x = _in(env, ins[0])
                if code == "DEQUANTIZE" and not x.is_floating_point():
                    x = (x.to(torch.float32) - float(t.zero_point[0])) * float(t.scale[0])
                env[outs[0]] = x.to(torch.float32)
            else:
                raise NotImplementedError(f"tflite import: builtin op {code}")
            for oidx in outs:
                env[oidx] = _fake_quant(oidx, env[oidx])

        results = []
        for idx in out_idx:
            y = _in(env, idx)
            t = tensors[idx]
            if t.quantized and not float_output:
                q = (torch.round(y * sc.recip(float(t.scale[0])))
                     + float(t.zero_point[0]))
                info = np.iinfo(t.dtype)
                y = torch.clamp(q, info.min, info.max).to(torch_dtype(t.dtype))
            results.append(y)
        return tuple(results)

    return fn


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` spells it."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def _strided_slice(x, cfg, begin, end, strides):
    if cfg["ellipsis_mask"] or cfg["new_axis_mask"]:
        raise NotImplementedError(
            "tflite import: STRIDED_SLICE ellipsis/new-axis mask")
    begin = np.asarray(begin).reshape(-1)
    end = np.asarray(end).reshape(-1)
    strides = np.asarray(strides).reshape(-1)
    shrink: List[int] = []
    for d in range(len(begin)):
        b, e, st = int(begin[d]), int(end[d]), int(strides[d])
        n = int(x.shape[d])
        if cfg["shrink_axis_mask"] & (1 << d):
            # tflite StartForAxis applies begin_mask BEFORE the shrink
            # (stop = start + 1): a set begin bit resets the start to 0
            if cfg["begin_mask"] & (1 << d):
                b = 0
            b = b if b >= 0 else b + n
            x = x.narrow(d, b, 1)
            shrink.append(d)
            continue
        sl = slice(None if cfg["begin_mask"] & (1 << d) else b,
                   None if cfg["end_mask"] & (1 << d) else e, st)
        start, stop, step = sl.indices(n)
        if step > 0:
            x = x[(slice(None),) * d + (slice(start, stop, step),)]
        else:  # torch slices take no negative step
            idx = torch.arange(start, stop, step, device=x.device)
            x = torch.index_select(x, d, idx)
    return x.squeeze(tuple(shrink)) if shrink else x


def _transpose_conv(x, w, cfg, out_shape, precision: str):
    """tflite TRANSPOSE_CONV: the input-gradient of the forward conv whose
    (OHWI) kernel is ``w``, cropped as TF's SAME/VALID padding has it."""
    sh, sw = cfg["strides"]
    oc, kh, kw, ic = (int(d) for d in w.shape)
    xt = x.permute(0, 3, 1, 2)
    wt = w.permute(3, 0, 1, 2)  # (in = x channels, out = oc, kh, kw)
    if precision == "highest":
        xt, wt = xt.double(), wt.double()
    elif precision == "default":
        xt, wt = xt.bfloat16(), wt.bfloat16()
    y = F.conv_transpose2d(xt, wt, stride=(sh, sw)).float()
    _, _, fh, fw = y.shape
    ih, iw = int(x.shape[1]), int(x.shape[2])
    if cfg["padding"] == "SAME":
        oh, ow = ih * sh, iw * sw
        pt = max(kh - sh, 0) // 2
        pl = max(kw - sw, 0) // 2
    else:
        oh, ow = (ih - 1) * sh + kh, (iw - 1) * sw + kw
        pt = pl = 0
    if fh < pt + oh or fw < pl + ow:
        y = F.pad(y, (0, max(pl + ow - fw, 0), 0, max(pt + oh - fh, 0)))
    y = y[:, :, pt:pt + oh, pl:pl + ow].permute(0, 2, 3, 1)
    if tuple(y.shape[1:]) != tuple(out_shape[1:]):
        raise NotImplementedError(
            f"tflite import: TRANSPOSE_CONV output shape "
            f"{tuple(y.shape)} != recorded {out_shape}")
    return y


def _gather(params, indices, axis: int, batch_dims: int):
    """``jnp.take(params, indices, axis)``, mapped over ``batch_dims``
    shared leading dims (tflite's axis counts those dims)."""
    indices = indices.to(torch.int64)
    if axis < 0:
        axis += params.ndim
    if batch_dims == 0:
        flat = torch.index_select(params, axis, indices.reshape(-1))
        return flat.reshape(tuple(params.shape[:axis]) + tuple(indices.shape)
                            + tuple(params.shape[axis + 1:]))
    bshape = tuple(params.shape[:batch_dims])
    b = int(np.prod(bshape))
    p = params.reshape((b,) + tuple(params.shape[batch_dims:]))
    inner = axis - batch_dims          # axis within one batch item
    p = p.movedim(inner + 1, 1)        # (B, A, pre..., post...)
    ishape = tuple(indices.shape[batch_dims:])
    idx = indices.reshape(b, -1)
    rows = torch.arange(b, device=p.device)[:, None]
    out = p[rows, idx]                 # (B, M, pre..., post...)
    out = out.reshape((b,) + ishape + tuple(out.shape[2:]))
    n_i = len(ishape)
    perm = ([0] + [1 + n_i + k for k in range(inner)]
            + [1 + k for k in range(n_i)]
            + list(range(1 + n_i + inner, out.ndim)))
    out = out.permute(*perm)
    return out.reshape(bshape + tuple(out.shape[1:]))


def _parse_options(options: Dict[str, str]):
    """(q_exec, float_output, precision, batch_opt, batch_n) with the
    reference's error texts."""
    float_output = str(options.get("float_output", "")).lower() in ("1", "true", "yes")
    q_exec = str(options.get("quantized_exec", "fake-quant")
                 ).lower().replace("_", "-")
    if q_exec not in ("fake-quant", "int8", "int8-native", "float"):
        raise ValueError(
            f"tflite import: quantized_exec:{q_exec!r} not one of "
            "fake-quant|int8|int8-native|float")
    batch_opt = options.get("batch")
    batch_n = 1
    if batch_opt:
        try:
            batch_n = int(batch_opt)
        except ValueError:
            raise ValueError(f"tflite option batch:{batch_opt!r} is not an "
                             "integer")
        if batch_n < 1:
            raise ValueError(f"tflite option batch:{batch_n} must be >= 1")
    prec_name = str(options.get("precision", "highest")).lower()
    if prec_name not in _PRECISIONS:
        raise ValueError(
            f"tflite import: precision:{prec_name!r} not one of "
            "highest|high|default")
    return q_exec, float_output, prec_name, batch_opt, batch_n


def read_model(path: str):
    """(steps, tensors, consts, raw_consts, in_idx, out_idx) of ``path``'s
    first subgraph; constants are owned copies (weights dequantized to
    float32 in ``consts``, raw in ``raw_consts``)."""
    with open(path, "rb") as fh:
        data = fh.read()
    model = tflite_schema.Model(data)
    sg = model.subgraphs[0]
    tensors = [_Tensor(t, model.buffers) for t in sg.tensors]
    in_idx = [int(i) for i in sg.inputs]
    out_idx = [int(i) for i in sg.outputs]
    opcodes = [oc.code for oc in model.operator_codes]

    steps: List[Tuple[str, dict, List[int], List[int]]] = []
    for op in sg.operators:
        code = tflite_schema.builtin_name(opcodes[op.opcode_index])
        ins = [int(x) for x in op.inputs]
        outs = [int(x) for x in op.outputs]
        steps.append((code, _parse_step(code, op, tensors), ins, outs))

    consts: Dict[int, np.ndarray] = {}
    raw_consts: Dict[int, np.ndarray] = {}
    for idx, t in enumerate(tensors):
        if t.data is not None:
            raw_consts[idx] = np.array(t.data)  # owned copy
            consts[idx] = t.dequantized() if t.quantized else t.data.astype(t.dtype)
            t.data = None
    return steps, tensors, consts, raw_consts, in_idx, out_idx


def load_tflite(path: str, options: Optional[Dict[str, str]] = None,
                device=None) -> Tuple[Callable, TensorsInfo, TensorsInfo]:
    """Parse ``path`` and return ``(fn, in_info, out_info)``.

    ``fn(*inputs)`` takes torch tensors on ``device`` (``None`` → cuda:0;
    numpy arrays are moved there) and returns a tuple of tensors there;
    quantized inputs may be fed as their integer dtype (dequantized
    in-graph) or pre-dequantized float32. ``options['float_output']``
    truthy → skip output re-quantization and emit float32.
    ``options['precision']`` = highest (default) | high | default (module
    docstring). ``options['quantized_exec']`` (quantized graphs) =
    fake-quant (default — float simulation of the integer graph, the
    parity oracle) | int8 (int8 GEMMs with int32 accumulators + requantize,
    tflite_int8.py) | int8-native (the C++ engine on the host,
    tflite_q8_native.py; ``fn.host_native``) | float (dequantized-weight
    float inference with the quant-RANGE clamps, no grid rounding).
    ``options['batch']`` = N → relabel the recorded batch-1 contract to N
    (the graph must be batch-polymorphic — checked at load by a pass over
    meta tensors, which does no arithmetic).

    Every callable but int8-native makes no host synchronisation and
    declares ``capture_safe = True``; each has ``output_info(in_info)``.
    """
    options = options or {}
    q_exec, float_output, precision, batch_opt, batch_n = _parse_options(
        options)
    batch_mode = bool(batch_opt)
    steps, tensors, consts, raw_consts, in_idx, out_idx = read_model(path)

    def build(dev: torch.device):
        if q_exec == "int8":
            from .tflite_int8 import build_int8_fn

            return build_int8_fn(steps, tensors, raw_consts, in_idx, out_idx,
                                 float_output, dev)
        return build_float_fn(steps, tensors, consts, raw_consts, in_idx,
                              out_idx, q_exec, float_output, batch_mode,
                              precision, dev)

    if q_exec == "int8" and not any(tensors[i].quantized for i in in_idx):
        raise ValueError(
            f"tflite import: quantized_exec:int8 needs a quantized "
            f"graph; {os.path.basename(path)} has float inputs")
    if q_exec == "int8-native":
        # C++ engine with requantize fused into the GEMM epilogue
        # (native/csrc/nns_q8.cc) — the arithmetic twin of the int8 path;
        # fn runs on the host (fn.host_native)
        from .tflite_q8_native import build_native_fn

        fn = build_native_fn(steps, tensors, raw_consts, in_idx, out_idx,
                             float_output, batch=batch_n)
    else:
        fn = _Served(build(resolve_device(device)),
                     build(torch.device("meta")))

    def _spec(idx, force_float):
        t = tensors[idx]
        dt = np.float32 if (force_float and t.quantized) else t.dtype
        return TensorSpec(t.shape, DataType.from_any(np.dtype(dt)))

    in_info = TensorsInfo.of(*(_spec(i, False) for i in in_idx))
    out_info = TensorsInfo.of(*(_spec(i, float_output) for i in out_idx))

    # options['batch'] = N: relabel the recorded batch-1 leading dims to N
    # and re-derive out_info from a pass over meta tensors, so the filter's
    # stream validation accepts aggregated batches
    if batch_opt:
        b = batch_n

        def _rebatch(info):
            return TensorsInfo.of(*(
                TensorSpec((b,) + tuple(s.shape[1:]), s.dtype)
                for s in info.specs))

        in_info = _rebatch(in_info)
        if getattr(fn, "host_native", False):
            # build_native_fn baked the batch into buffer sizes; the
            # contract relabel is all that's left to do here
            return fn, in_info, _rebatch(out_info)
        try:
            out_shapes = _meta_outputs(fn.meta_fn, in_info)
        except Exception as e:
            raise ValueError(
                f"tflite option batch:{b}: {os.path.basename(path)} is not "
                f"batch-polymorphic (shape tracing failed: {e}); remove "
                "the batch option and run per-frame") from e
        # a graph that is NOT batch-polymorphic (e.g. a reshape that
        # hard-flattens everything) must fail AT LOAD with the cause, not
        # stream interleaved frames downstream
        for o in out_shapes:
            if not o.shape or o.shape[0] != b:
                raise ValueError(
                    f"tflite option batch:{b}: {os.path.basename(path)} is "
                    f"not batch-polymorphic (an output has shape "
                    f"{tuple(o.shape)}, leading dim != {b}); remove the batch "
                    "option and run per-frame")
        out_info = TensorsInfo.of(*(
            TensorSpec(tuple(o.shape), DataType.from_any(o.dtype))
            for o in out_shapes))
    return fn, in_info, out_info


def _meta_outputs(meta_fn, in_info: TensorsInfo):
    metas = [torch.empty(s.shape, dtype=s.dtype.torch_dtype, device="meta")
             for s in in_info.specs]
    with torch.inference_mode():
        return meta_fn(*metas)


class _Served:
    """A device executor as the torch backend serves it: a CUDA graph may
    capture it (no host synchronisation, no host reads), and its output
    shapes come from a pass over meta tensors."""

    capture_safe = True

    def __init__(self, fn: Callable, meta_fn: Callable):
        self.fn = fn
        self.meta_fn = meta_fn

    def __call__(self, *xs):
        return self.fn(*xs)

    def output_info(self, in_info: TensorsInfo) -> TensorsInfo:
        return TensorsInfo.of(*(
            TensorSpec(tuple(o.shape), DataType.from_any(o.dtype))
            for o in _meta_outputs(self.meta_fn, in_info)))
