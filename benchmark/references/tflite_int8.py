"""Plain reference of TFLite's int8 semantics, in PyTorch.

It executes a full-integer ``.tflite`` classifier the way TFLite's
reference kernels define it: int32 accumulators of zero-point-shifted
int8 products plus the int32 bias, requantised by the fixed-point
multiplier and shift that ``QuantizeMultiplier`` derives from the scales
(``SaturatingRoundingDoublingHighMul`` then ``RoundingDivideByPOT``; the
per-channel FULLY_CONNECTED in one rounding), the
output zero point added and the fused activation's range clamped. ADD
rescales both inputs by 2**20 as ``reference_integer_ops::Add`` does,
and MEAN requantises the zero-point-shifted sum by one multiplier
that folds in the division by the window's size, as TFLite's int8
MEAN does.

The products are summed as float64 convolutions of integers. Every
partial sum stays far below 2**53, so each is exact whatever the order,
and the rest is int64 arithmetic. It runs on any device.

``bits=4`` is the control, the same network computed in int4, the step
below the int8 the model states: every weight and every activation an
op writes keeps its scale and zero point but only its top four bits
(rounded to a multiple of 16 from the zero point, clamped to int4).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..tflite_reader import Graph, read_graph

RELU, RELU_N1_TO_1, RELU6 = 1, 2, 3
SAME, VALID = 0, 1


def _round_away(x: float) -> int:
    """std::round: half away from zero."""
    return int(math.copysign(math.floor(abs(x) + 0.5), x))


def quantize_multiplier(m: float) -> Tuple[int, int]:
    """TFLite's QuantizeMultiplier: ``m = q * 2**(shift - 31)`` with q a
    31-bit fixed-point fraction in [2**30, 2**31)."""
    if m == 0.0:
        return 0, 0
    q, shift = math.frexp(m)
    qf = _round_away(q * (1 << 31))
    if qf == 1 << 31:
        qf //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    return qf, shift


def srdhm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SaturatingRoundingDoublingHighMul on int64 tensors holding int32
    values: round(a * b / 2**31), halves away from zero, truncating the
    nudged product as C++ division does."""
    ab = a * b
    nudge = torch.where(ab >= 0, torch.full_like(ab, 1 << 30),
                        torch.full_like(ab, 1 - (1 << 30)))
    return torch.div(ab + nudge, 1 << 31, rounding_mode="trunc")


def rdbypot(x: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """RoundingDivideByPOT: x / 2**exponent, halves away from zero."""
    mask = (torch.ones_like(exponent) << exponent) - 1
    remainder = x & mask
    threshold = (mask >> 1) + (x < 0).to(x.dtype)
    return (x >> exponent) + (remainder > threshold).to(x.dtype)


def mbqm(x: torch.Tensor, qm: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """MultiplyByQuantizedMultiplier: two roundings, as the convolutions,
    ADD and MEAN of TFLite's reference kernels requantise."""
    left = shift.clamp(min=0)
    right = (-shift).clamp(min=0)
    return rdbypot(srdhm(x * (torch.ones_like(left) << left), qm), right)


def mbqm_single(x: torch.Tensor, qm: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The one-rounding form, ``(x * qm + 2**(30 - shift)) >> (31 - shift)``
    (halves toward +inf), as TFLite's per-channel FULLY_CONNECTED
    requantises."""
    total = 31 - shift
    return (x * qm + (torch.ones_like(total) << (total - 1))) >> total


def _act_range(act: int, scale: float, zp: int) -> Tuple[int, int]:
    """CalculateActivationRangeQuantized for int8 (f / scale in float32)."""
    lo, hi = -128, 127

    def q(f):
        return zp + _round_away(float(np.float32(f) / np.float32(scale)))

    if act == RELU:
        lo = max(lo, q(0.0))
    elif act == RELU6:
        lo, hi = max(lo, q(0.0)), min(hi, q(6.0))
    elif act == RELU_N1_TO_1:
        lo, hi = max(lo, q(-1.0)), min(hi, q(1.0))
    elif act != 0:
        raise ValueError(f"tflite reference: fused activation {act}")
    return lo, hi


def _same_pads(size: int, k: int, stride: int, dil: int,
               padding: int) -> Tuple[int, int, int]:
    """(output size, pad before, pad after) as ComputePaddingHeightWidth."""
    eff = (k - 1) * dil + 1
    if padding == SAME:
        out = (size + stride - 1) // stride
        total = max((out - 1) * stride + eff - size, 0)
        return out, total // 2, total - total // 2
    return (size - eff + stride) // stride, 0, 0


class TfliteInt8Reference:
    """``ref(x)``: (N, H, W, C) int8 input → the int8 output the model
    defines, on ``device``. Build once; call in blocks of frames."""

    def __init__(self, path, device="cpu", bits: int = 8):
        self.graph: Graph = read_graph(Path(path).read_bytes())
        self.device = torch.device(device)
        self.bits = bits
        self._steps = [self._prepare(op) for op in self.graph.ops]

    def _weights(self, w: np.ndarray) -> np.ndarray:
        w = w.astype(np.int64)
        if self.bits == 8:
            return w
        step = 1 << (8 - self.bits)
        top = (1 << (self.bits - 1)) - 1
        return np.clip(np.floor(w / step + 0.5), -top - 1, top).astype(np.int64) * step

    def _coarse(self, y: torch.Tensor, zp: int) -> torch.Tensor:
        """An activation on the ``bits`` grid around its zero point."""
        if self.bits == 8:
            return y
        step = 1 << (8 - self.bits)
        top = (1 << (self.bits - 1)) - 1
        q = torch.floor((y - zp).double() / step + 0.5).clamp(-top - 1, top)
        return (q.long() * step + zp).clamp(-128, 127)

    def _t(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    def _requant(self, in_scale: float, w_scale: np.ndarray,
                 out_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
        pairs = [quantize_multiplier(float(in_scale) * float(s) / float(out_scale))
                 for s in w_scale]
        return self._t([p[0] for p in pairs]), self._t([p[1] for p in pairs])

    def _prepare(self, op) -> Dict:
        g = self.graph
        ins = [g.tensors[i] for i in op.inputs if i >= 0]
        out = g.tensors[op.outputs[0]]
        o_scale, o_zp = float(out.scale[0]), int(out.zero_point[0])
        st = {"op": op.op, "in": op.inputs, "out": op.outputs[0],
              "out_zp": o_zp,
              "range": _act_range(op.options.get("activation", 0), o_scale, o_zp)}
        x = ins[0]
        st["in_zp"] = int(x.zero_point[0])
        if op.op in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            w, b = ins[1], ins[2]
            wt = self._weights(w.data)
            if op.op == "CONV_2D":               # (O, kh, kw, I) → (O, I, kh, kw)
                st["w"] = self._t(wt.transpose(0, 3, 1, 2), torch.float64)
                st["groups"] = 1
            else:                                # (1, kh, kw, C) → (C, 1, kh, kw)
                if op.options["depth_multiplier"] != 1:
                    raise ValueError("tflite reference: depth multiplier != 1")
                st["w"] = self._t(wt.transpose(3, 0, 1, 2), torch.float64)
                st["groups"] = wt.shape[3]
            st["bias"] = self._t(b.data)
            st["qm"], st["shift"] = self._requant(x.scale[0], w.scale, o_scale)
            st["opts"] = op.options
        elif op.op == "FULLY_CONNECTED":
            w, b = ins[1], ins[2]
            st["w"] = self._t(self._weights(w.data).T, torch.float64)   # (K, N)
            st["bias"] = self._t(b.data)
            # GetQuantizedConvolutionMultipler: the scales' product in float32
            prod = np.float32(x.scale[0]) * w.scale.astype(np.float32)
            st["qm"], st["shift"] = self._requant(1.0, prod, o_scale)
        elif op.op == "ADD":
            y = ins[1]
            s1, s2 = float(x.scale[0]), float(y.scale[0])
            twice_max = 2 * max(s1, s2)
            st["in2_zp"] = int(y.zero_point[0])
            st["m1"] = quantize_multiplier(s1 / twice_max)
            st["m2"] = quantize_multiplier(s2 / twice_max)
            st["mo"] = quantize_multiplier(twice_max / ((1 << 20) * o_scale))
        elif op.op == "MEAN":
            axes = g.tensors[op.inputs[1]].data
            if sorted(int(a) for a in axes.reshape(-1)) != [1, 2]:
                raise ValueError(f"tflite reference: MEAN over {axes}")
            n = x.shape[1] * x.shape[2]
            st["m"] = quantize_multiplier(float(x.scale[0]) / o_scale / n)
            st["keep_dims"] = op.options["keep_dims"]
        return st

    # -- execution -------------------------------------------------------
    def _finish(self, acc: torch.Tensor, st: Dict, qm, shift,
                requant=mbqm) -> torch.Tensor:
        lo, hi = st["range"]
        return (requant(acc, qm, shift) + st["out_zp"]).clamp(lo, hi)

    def _conv(self, x: torch.Tensor, st: Dict) -> torch.Tensor:
        o = st["opts"]
        xs = (x - st["in_zp"]).to(torch.float64).permute(0, 3, 1, 2)
        kh, kw = st["w"].shape[2:]
        _, ph0, ph1 = _same_pads(xs.shape[2], kh, o["stride_h"], o["dilation_h"], o["padding"])
        _, pw0, pw1 = _same_pads(xs.shape[3], kw, o["stride_w"], o["dilation_w"], o["padding"])
        xs = F.pad(xs, (pw0, pw1, ph0, ph1))
        acc = F.conv2d(xs, st["w"], stride=(o["stride_h"], o["stride_w"]),
                       dilation=(o["dilation_h"], o["dilation_w"]),
                       groups=st["groups"])
        acc = acc.permute(0, 2, 3, 1).round().to(torch.int64) + st["bias"]
        return self._finish(acc, st, st["qm"], st["shift"])

    def _fc(self, x: torch.Tensor, st: Dict) -> torch.Tensor:
        xs = (x.reshape(x.shape[0], -1) - st["in_zp"]).to(torch.float64)
        acc = (xs @ st["w"]).round().to(torch.int64) + st["bias"]
        return self._finish(acc, st, st["qm"], st["shift"], mbqm_single)

    def _add(self, x: torch.Tensor, y: torch.Tensor, st: Dict) -> torch.Tensor:
        def scaled(v, m):
            qm = torch.tensor(m[0], device=v.device)
            return rdbypot(srdhm(v, qm), torch.tensor(-m[1], device=v.device))

        raw = (scaled((x - st["in_zp"]) * (1 << 20), st["m1"])
               + scaled((y - st["in2_zp"]) * (1 << 20), st["m2"]))
        lo, hi = st["range"]
        return (scaled(raw, st["mo"]) + st["out_zp"]).clamp(lo, hi)

    def _mean(self, x: torch.Tensor, st: Dict) -> torch.Tensor:
        acc = (x - st["in_zp"]).sum(dim=(1, 2))
        qm, shift = (torch.tensor(st["m"][0], device=x.device),
                     torch.tensor(st["m"][1], device=x.device))
        acc = mbqm(acc, qm, shift)
        lo, hi = st["range"]
        acc = (acc + st["out_zp"]).clamp(lo, hi)
        return acc[:, None, None, :] if st["keep_dims"] else acc

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: int8 (N, H, W, C) on any device. Returns the int8 output;
        each activation is dropped after the last op that reads it."""
        last_use = {i: st for st in self._steps for i in st["in"]}
        vals: Dict[int, torch.Tensor] = {
            self.graph.inputs[0]: x.to(self.device, torch.int64)}
        for st in self._steps:
            ins = [vals[i] for i in st["in"] if i >= 0 and i in vals]
            kind = st["op"]
            if kind in ("CONV_2D", "DEPTHWISE_CONV_2D"):
                y = self._conv(ins[0], st)
            elif kind == "FULLY_CONNECTED":
                y = self._fc(ins[0], st)
            elif kind == "ADD":
                y = self._add(ins[0], ins[1], st)
            else:
                y = self._mean(ins[0], st)
            vals[st["out"]] = self._coarse(y, st["out_zp"])
            for i in st["in"]:
                if i != self.graph.outputs[0] and i in vals and last_use[i] is st:
                    del vals[i]
        return vals[self.graph.outputs[0]].to(torch.int8)


def int8_input(frames_u8: torch.Tensor) -> torch.Tensor:
    """The uint8 camera frames as the int8 model input: ``x - 128``."""
    return (frames_u8.to(torch.int16) - 128).to(torch.int8)

