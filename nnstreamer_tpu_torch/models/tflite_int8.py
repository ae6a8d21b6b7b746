"""True integer-arithmetic executor for quantized tflite imports.

The counterpart of nnstreamer_tpu's ``models/tflite_int8.py``: the SAME
parsed graph as ``tflite_import.py`` runs with integer arithmetic end to
end, on the filter's device:

* activations live as int8 (uint8 tensors are re-biased by -128 so both
  storage types share one symmetric int8 representation — "stored zero
  point" ``zp8 = zp - 128`` for uint8, ``zp`` for int8),
* convs/matmuls run as int8 x int8 -> int32 GEMMs (conv via im2col patch
  extraction) through ``torch._int_mm``; on the card its shape rules
  (more than 16 rows, K and N multiples of 8) are met by zero padding,
  which leaves every accumulator unchanged,
* depthwise convs run as shifted multiply-adds on zero-point-subtracted
  values in float32 — integer-exact, every partial sum stays under 2^24,
* accumulators are exact int32; requantization multiplies by the float32
  scale ratio and rounds half to even (``torch.round``, as the reference's
  ``jnp.round`` and the native engine's ``lrintf`` do), adds the output
  zero point and clamps to the fused-activation range.

Supported ops are the quantized-model vocabulary of the reference zoo
(CONV_2D, DEPTHWISE_CONV_2D, FULLY_CONNECTED, ADD, AVERAGE/MAX_POOL_2D,
MEAN, RESHAPE, PAD, CONCATENATION, SOFTMAX, LOGISTIC, DEQUANTIZE);
anything else raises with a pointer at the fake-quant oracle path.

Select with ``tensor_filter framework=torch model=x.tflite
custom=quantized_exec:int8``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .tflite_import import (
    _ACT_NONE,
    _ACT_RELU,
    _ACT_RELU6,
    _ACT_RELU_N1_1,
    ScalarCache,
    _as_torch,
    depthwise_shift_add,
    explicit_padding,
    im2col,
    pad_nhwc,
    pool_counts,
    softmax,
    window_taps,
)


def _stored(t) -> Tuple[float, int]:
    """(scale, stored-domain zero point) of a quantized tensor: uint8
    tensors are carried as int8 shifted by -128."""
    zp = int(t.zero_point[0])
    if t.dtype == np.uint8:
        zp -= 128
    return float(t.scale[0]), zp


def _act_bounds(act: int, scale: float, zp8: int) -> Tuple[int, int]:
    """tflite CalculateActivationRangeQuantized in the stored int8 domain:
    the fused clamp intersects the dtype range."""
    lo, hi = -128, 127
    if act == _ACT_RELU:
        lo = max(lo, zp8)
    elif act == _ACT_RELU6:
        lo = max(lo, zp8)
        hi = min(hi, zp8 + int(round(6.0 / scale)))
    elif act == _ACT_RELU_N1_1:
        lo = max(lo, zp8 - int(round(1.0 / scale)))
        hi = min(hi, zp8 + int(round(1.0 / scale)))
    elif act != _ACT_NONE:
        raise NotImplementedError(f"int8 exec: fused activation {act}")
    return lo, hi


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def pad_weight(w_nk: np.ndarray, device: torch.device) -> np.ndarray:
    """The (N, K) int8 weight as ``int_mm`` takes it on ``device``: on the
    card zero-padded to multiples of 8 in N and K (``torch._int_mm``'s
    rule; zero rows and columns add zero products only)."""
    if device.type != "cuda":
        return w_nk
    n, k = w_nk.shape
    return np.pad(w_nk, ((0, _round8(n) - n), (0, _round8(k) - k)))


def int_mm(a: torch.Tensor, b_nk: torch.Tensor, n: int) -> torch.Tensor:
    """(M, K) int8 @ (K, n) int8 → (M, n) int32, with ``b_nk`` the (N, K')
    weight from :func:`pad_weight`. On the card ``a`` is zero-padded to
    K' columns and to more than 16 rows, ``torch._int_mm``'s rules."""
    m, k = int(a.shape[0]), int(a.shape[1])
    if a.device.type != "cuda":
        return torch._int_mm(a, b_nk.t())
    kp = int(b_nk.shape[1])
    mp = max(m, 17)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    out = torch._int_mm(a.contiguous(), b_nk.t())
    return out[:m, :n]


def build_int8_fn(steps, tensors, raw_consts: Dict[int, np.ndarray],
                  in_idx: List[int], out_idx: List[int], float_output: bool,
                  device: torch.device):
    """Return ``fn(*inputs)`` executing ``steps`` with integer arithmetic on
    ``device`` (see module docstring). Mirrors ``load_tflite``'s calling
    convention so the caller's info/batch plumbing is shared. Weights,
    multipliers and folded zero-point terms go to ``device`` now."""
    meta = device.type == "meta"
    sc = ScalarCache(device)
    sc.prefill(steps, tensors, raw_consts)

    def _dev(a: np.ndarray, dtype) -> torch.Tensor:
        if meta:
            return torch.empty(a.shape, dtype=dtype, device=device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)

    def _weights8(idx) -> Tuple[np.ndarray, np.ndarray]:
        """(stored int8 weights, per-channel stored zero points)."""
        t = tensors[idx]
        w = raw_consts[idx]
        zp = t.zero_point.astype(np.int32)
        if t.dtype == np.uint8:
            w8 = (w.astype(np.int32) - 128).astype(np.int8)
            zp8 = zp - 128
        elif t.dtype == np.int8:
            w8, zp8 = w, zp
        else:
            raise NotImplementedError(
                f"int8 exec: weight dtype {t.dtype} (tensor {idx})")
        return w8, zp8

    def _mult(in_scale: float, w_scale: np.ndarray, out_scale: float):
        m = (in_scale * w_scale.astype(np.float64) / out_scale).astype(np.float32)
        return _dev(m, torch.float32) if m.size > 1 else float(m)

    def _bias(ins):
        return raw_consts[ins[2]] if len(ins) > 2 and ins[2] >= 0 else None

    # per-step constants on the device: GEMM weights (N, K) with the folded
    # zero-point/bias term, depthwise weights, multipliers
    prep: Dict[int, Dict[str, Any]] = {}
    for si, (code, cfg, ins, outs) in enumerate(steps):
        if code not in ("CONV_2D", "FULLY_CONNECTED", "DEPTHWISE_CONV_2D"):
            continue
        t_in, t_w, t_out = tensors[ins[0]], tensors[ins[1]], tensors[outs[0]]
        s_in, xzp8 = _stored(t_in)
        w8, wzp8 = _weights8(ins[1])
        s_out, yzp8 = _stored(t_out)
        bias = _bias(ins)
        p: Dict[str, Any] = {
            "mult": _mult(s_in, t_w.scale, s_out), "xzp8": xzp8,
            "yzp8": yzp8, "bounds": _act_bounds(cfg["act"], s_out, yzp8)}
        if code == "DEPTHWISE_CONV_2D":
            wf = (w8.astype(np.int32)
                  - wzp8.reshape(1, 1, 1, -1)).astype(np.float32)
            p["wf"] = _dev(wf, torch.float32)
            p["bias"] = (_dev(bias.astype(np.float32), torch.float32)
                         if bias is not None else None)
        else:
            if code == "CONV_2D":
                oc, kh, kw, ic = w8.shape
                p["kernel"] = (kh, kw)
                # K-order of patches is (ky, kx, ic) — match it
                w_nk = w8.reshape(oc, kh * kw * ic)
            else:
                w_nk = w8
                oc = w8.shape[0]
            k = w_nk.shape[1]
            wzp = np.broadcast_to(np.asarray(wzp8, np.int64), (oc,))
            # sum (p-xzp)(w-wzp) = dot(p,w) - wzp*rowsum(p) - xzp*colsum(w)
            # + K*xzp*wzp; all but the rowsum term fold into one constant
            const = (-xzp8 * w_nk.astype(np.int64).sum(axis=1)
                     + k * xzp8 * wzp)
            if bias is not None:
                const = const + bias.astype(np.int64)
            p["w_nk"] = _dev(pad_weight(w_nk, device), torch.int8)
            p["n"] = oc
            p["const"] = _dev(const.astype(np.int32), torch.int32)
            p["wzp"] = (_dev(wzp.astype(np.int32), torch.int32)
                        if np.any(wzp != 0) else None)
        prep[si] = p

    def _requant(acc, mult, zp8: int, lo: int, hi: int):
        y = torch.round(acc.to(torch.float32) * mult) + zp8
        return torch.clamp(y, lo, hi).to(torch.int8)

    def _dequant(x8, t):
        s, zp8 = _stored(t)
        return (x8.to(torch.float32) - zp8) * s

    def _quant_full(yf, t):
        s, zp8 = _stored(t)
        q = torch.round(yf / sc(s)) + zp8
        return torch.clamp(q, -128, 127).to(torch.int8)

    def _gemm(p8, p):
        """int8 GEMM over the last axis of ``p8`` with the zero-point and
        bias corrections of step ``p``."""
        lead = tuple(p8.shape[:-1])
        a = p8.reshape(-1, p8.shape[-1])
        acc = int_mm(a, p["w_nk"], p["n"])
        if p["wzp"] is not None:
            acc = acc - a.sum(dim=1, keepdim=True, dtype=torch.int32) * p["wzp"]
        acc = acc + p["const"]
        return acc.reshape(lead + (acc.shape[-1],))

    def _rescale(x8, s_in, izp8, s_out, yzp8, lo=-128, hi=127):
        yf = (x8.to(torch.float32) - izp8) * s_in / sc(s_out)
        return torch.clamp(torch.round(yf) + yzp8, lo, hi).to(torch.int8)

    def _const_op(idx) -> np.ndarray:
        if idx not in raw_consts:
            raise NotImplementedError(
                f"int8 exec: dynamic shape operand tensor {idx}")
        return raw_consts[idx]

    def fn(*inputs):
        env: Dict[int, Any] = {}
        for i, idx in enumerate(in_idx):
            t = tensors[idx]
            x = _as_torch(inputs[i], device)
            if x.is_floating_point():
                env[idx] = _quant_full(x, t)  # pre-dequantized float feed
            elif t.dtype == np.uint8:
                env[idx] = (x.to(torch.int32) - 128).to(torch.int8)
            else:
                env[idx] = x.to(torch.int8)

        for si, (code, cfg, ins, outs) in enumerate(steps):
            t_out = tensors[outs[0]]
            if code in ("CONV_2D", "FULLY_CONNECTED"):
                p = prep[si]
                x8 = env[ins[0]]
                if code == "CONV_2D":
                    kh, kw = p["kernel"]
                    if kh == kw == 1 and tuple(cfg["strides"]) == (1, 1):
                        p8 = x8
                    else:
                        p8 = im2col(x8, kh, kw, cfg["strides"],
                                    cfg["dilation"], cfg["padding"],
                                    p["xzp8"])
                    acc = _gemm(p8, p)
                else:
                    acc = _gemm(x8.reshape(x8.shape[0], -1), p)
                env[outs[0]] = _requant(acc, p["mult"], p["yzp8"],
                                        *p["bounds"])
            elif code == "DEPTHWISE_CONV_2D":
                p = prep[si]
                xf = env[ins[0]].to(torch.float32) - float(p["xzp8"])
                acc = depthwise_shift_add(
                    xf, p["wf"], cfg["strides"], cfg["padding"],
                    cfg["dilation"])
                if p["bias"] is not None:
                    acc = acc + p["bias"]
                env[outs[0]] = _requant(acc, p["mult"], p["yzp8"],
                                        *p["bounds"])
            elif code == "ADD":
                a8, b8 = env[ins[0]], env[ins[1]]
                sa, azp8 = _stored(tensors[ins[0]])
                sb, bzp8 = _stored(tensors[ins[1]])
                s_out, yzp8 = _stored(t_out)
                lo, hi = _act_bounds(cfg["act"], s_out, yzp8)
                yf = ((a8.to(torch.float32) - azp8) * sa
                      + (b8.to(torch.float32) - bzp8) * sb) / sc(s_out)
                env[outs[0]] = torch.clamp(torch.round(yf) + yzp8, lo, hi
                                           ).to(torch.int8)
            elif code in ("AVERAGE_POOL_2D", "MAX_POOL_2D"):
                x8 = env[ins[0]]
                s_in, xzp8 = _stored(tensors[ins[0]])
                s_out, yzp8 = _stored(t_out)
                lo, hi = _act_bounds(cfg["act"], s_out, yzp8)
                kh, kw = cfg["filter"]
                oh, ow, pads = explicit_padding(
                    int(x8.shape[1]), int(x8.shape[2]), kh, kw,
                    cfg["strides"], (1, 1), cfg["padding"])
                if code == "MAX_POOL_2D":
                    taps = window_taps(pad_nhwc(x8, pads, -128), kh, kw, oh,
                                       ow, cfg["strides"])
                    y = taps[0]
                    for sl in taps[1:]:
                        y = torch.maximum(y, sl)
                    # max-pool passes values through; rescale only if the
                    # graph declares different in/out quantization
                    if (s_in, xzp8) == (s_out, yzp8):
                        env[outs[0]] = torch.clamp(y, lo, hi).to(torch.int8)
                    else:
                        env[outs[0]] = _rescale(y, s_in, xzp8, s_out, yzp8,
                                                lo, hi)
                else:
                    x32 = x8.to(torch.int32) - xzp8
                    taps = window_taps(pad_nhwc(x32, pads, 0), kh, kw, oh,
                                       ow, cfg["strides"])
                    total = taps[0]
                    for sl in taps[1:]:
                        total = total + sl
                    count = pool_counts(x8, kh, kw, cfg["strides"],
                                        cfg["padding"])
                    yf = total.to(torch.float32) / count * (s_in / s_out)
                    env[outs[0]] = torch.clamp(torch.round(yf) + yzp8, lo, hi
                                               ).to(torch.int8)
            elif code == "MEAN":
                x8 = env[ins[0]]
                axes = tuple(int(a) for a in
                             np.atleast_1d(_const_op(ins[1])))
                s_in, xzp8 = _stored(tensors[ins[0]])
                s_out, yzp8 = _stored(t_out)
                n = int(np.prod([x8.shape[a] for a in axes]))
                m = (x8.to(torch.float32) - xzp8).sum(
                    dim=axes, keepdim=cfg["keepdims"]) / sc(float(n))
                yf = m * (s_in / s_out)
                env[outs[0]] = torch.clamp(torch.round(yf) + yzp8, -128, 127
                                           ).to(torch.int8)
            elif code == "RESHAPE":
                x8 = env[ins[0]]
                if "new_shape" in cfg:
                    shape = list(cfg["new_shape"])
                else:
                    shape = [int(v) for v in
                             np.asarray(_const_op(ins[1])).reshape(-1)]
                if shape and shape[0] == 1 and x8.shape[0] != 1 and (
                        -1 not in shape
                        and int(np.prod(shape)) != int(np.prod(x8.shape))):
                    shape[0] = int(x8.shape[0])
                env[outs[0]] = x8.reshape(shape)
            elif code == "PAD":
                pads = np.asarray(_const_op(ins[1])).reshape(-1, 2)
                _, xzp8 = _stored(tensors[ins[0]])
                flat = [int(v) for p in pads[::-1] for v in p]
                env[outs[0]] = F.pad(env[ins[0]], flat, value=xzp8)
            elif code == "CONCATENATION":
                s_out, yzp8 = _stored(t_out)
                parts = []
                for i in ins:
                    s_i, izp8 = _stored(tensors[i])
                    p = env[i]
                    if (s_i, izp8) != (s_out, yzp8):
                        p = _rescale(p, s_i, izp8, s_out, yzp8)
                    parts.append(p)
                env[outs[0]] = torch.cat(parts, dim=cfg["axis"] % parts[0].ndim)
            elif code == "SOFTMAX":
                yf = softmax(_dequant(env[ins[0]], tensors[ins[0]]) * cfg["beta"])
                env[outs[0]] = _quant_full(yf, t_out)
            elif code == "LOGISTIC":
                yf = torch.sigmoid(_dequant(env[ins[0]], tensors[ins[0]]))
                env[outs[0]] = _quant_full(yf, t_out)
            elif code == "DEQUANTIZE":
                env[outs[0]] = _dequant(env[ins[0]], tensors[ins[0]])
            else:
                raise NotImplementedError(
                    f"int8 exec: builtin op {code} has no integer kernel "
                    "here; run this model with quantized_exec:fake-quant")

        results = []
        for idx in out_idx:
            y = env[idx]
            t = tensors[idx]
            if not t.quantized:  # e.g. after DEQUANTIZE
                results.append(y)
            elif float_output:
                results.append(_dequant(y, t))
            elif t.dtype == np.uint8:
                results.append((y.to(torch.int32) + 128).to(torch.uint8))
            else:
                results.append(y)
        return tuple(results)

    return fn
