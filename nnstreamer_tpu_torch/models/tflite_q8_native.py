"""Builder: parsed quantized tflite graph -> native int8 engine program.

The counterpart of nnstreamer_tpu's ``models/tflite_q8_native.py``, over
the same C++ engine (``native/csrc/nns_q8.cc``); the program runs on the
host. ``quantized_exec:int8-native`` — the third execution mode for
quantized imports, next to ``fake-quant`` (byte oracle) and ``int8`` (the
integer path on the device). It targets the one gap the XLA path of
nnstreamer_tpu cannot close on CPU: XLA
materializes each layer's int32 accumulator and requantizes in a
separate elementwise pass, while the reference's interpreter
(ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc ->
XNNPACK) fuses requantization into the GEMM microkernel. The native
engine (native/csrc/nns_q8.cc, AVX512-VNNI with scalar fallback) does
the same fusion, sharing the int8 path's arithmetic (``tflite_int8.py``)
so the two check each other byte-for-byte.

Supported vocabulary: CONV_2D, DEPTHWISE_CONV_2D (multiplier 1),
FULLY_CONNECTED, ADD, AVERAGE_POOL_2D, MEAN(h,w), RESHAPE, SOFTMAX —
the reference zoo's quantized models. Anything else raises with a
pointer at the device modes.

Domain conventions (must mirror tflite_int8.py, shifted to unsigned):
activations u8 (int8 tensors biased +128), weights s8 (uint8 weights
biased -128), zero points in the same domains.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .tflite_int8 import _act_bounds
from .tflite_import import _ACT_NONE, explicit_padding


def _u8dom(t):
    """(scale, u8-domain zero point) of an activation tensor."""
    zp = int(t.zero_point[0])
    if t.dtype == np.int8:
        zp += 128
    return float(t.scale[0]), zp


def _bounds_u8(act: int, scale: float, zp_u8: int):
    lo, hi = _act_bounds(act, scale, zp_u8 - 128)
    return lo + 128, hi + 128


def _w_s8(t, w: np.ndarray):
    """(s8-domain weights, per-channel s8-domain zero points)."""
    zp = np.atleast_1d(t.zero_point).astype(np.int64)
    if t.dtype == np.uint8:
        return (w.astype(np.int16) - 128).astype(np.int8), zp - 128
    if t.dtype == np.int8:
        return w.astype(np.int8), zp
    raise NotImplementedError(f"int8-native: weight dtype {t.dtype}")


def _per_oc(v: np.ndarray, oc: int) -> np.ndarray:
    v = np.atleast_1d(np.asarray(v))
    return np.broadcast_to(v, (oc,)).copy() if v.size != oc else v


def build_native_fn(steps, tensors, raw_consts: Dict[int, np.ndarray],
                    in_idx: List[int], out_idx: List[int],
                    float_output: bool, batch: int = 1):
    """Return a host-native ``fn(*inputs) -> tuple`` running ``steps``
    on the C++ engine. ``fn.host_native`` marks it as host work: the
    torch backend pulls card inputs to the host once per batch and never
    lets it join a fused segment. Inputs may be numpy arrays or torch
    tensors; outputs are numpy arrays."""
    from ..native import q8

    if not q8.available():
        raise RuntimeError(
            "quantized_exec:int8-native — native engine unavailable "
            "(build failed or NNS_DISABLE_NATIVE set); use "
            "quantized_exec:int8 for the integer path on the device")
    if not any(tensors[i].quantized for i in in_idx):
        raise ValueError("quantized_exec:int8-native needs a quantized graph")

    n = int(batch)
    prog = q8.Q8Program(len(tensors))
    # activation buffers: graph inputs + every op output (batch-scaled)
    live = set(in_idx)

    def _elems(t) -> int:
        """Batch-scaled element count of an activation. Only a recorded
        leading dim of 1 is relabelable as batch; any other shape (rank-1
        outputs, hard-flattening RESHAPEs) is taken verbatim and must
        fail AT LOAD when batch > 1 — mirrors the device path's meta-tensor
        validation."""
        if len(t.shape) > 0 and t.shape[0] == 1:
            return n * int(np.prod(t.shape[1:], dtype=np.int64))
        if n > 1:
            raise ValueError(
                f"int8-native batch:{n}: activation with recorded shape "
                f"{t.shape} (leading dim != 1) — graph is not "
                "batch-polymorphic; remove the batch option")
        return int(np.prod(t.shape, dtype=np.int64)) if t.shape else 1

    def _ensure_buf(idx: int) -> None:
        prog.buf(idx, max(1, _elems(tensors[idx])))
        live.add(idx)

    for idx in in_idx:
        _ensure_buf(idx)

    def _bias(ins) -> np.ndarray | None:
        if len(ins) > 2 and ins[2] >= 0:
            if ins[2] not in raw_consts:
                # the int8 twin indexes raw_consts directly and fails at
                # load; a silent all-zero bias would diverge byte-wise
                raise NotImplementedError(
                    "int8-native: non-constant bias operand unsupported; "
                    "use quantized_exec:int8")
            return raw_consts[ins[2]].astype(np.int32)
        return None

    for code, cfg, ins, outs in steps:
        t_out = tensors[outs[0]]
        if code == "RESHAPE":
            if ins[0] not in live:
                raise NotImplementedError(
                    "int8-native: RESHAPE of a constant operand "
                    "unsupported; use quantized_exec:int8")
            prog.alias(outs[0], ins[0])
            live.add(outs[0])
            continue
        if code in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            t_in, t_w = tensors[ins[0]], tensors[ins[1]]
            if ins[1] not in raw_consts:
                raise NotImplementedError(
                    f"int8-native: {code} with non-constant weights")
            s_in, xzp = _u8dom(t_in)
            s_out, yzp = _u8dom(t_out)
            w8, wzp = _w_s8(t_w, raw_consts[ins[1]])
            bias = _bias(ins)
            lo, hi = _bounds_u8(cfg.get("act", _ACT_NONE), s_out, yzp)
            if code == "FULLY_CONNECTED":
                oc, k = w8.shape
                # tflite FC flattens everything but the batch dim; the
                # native conv kernel reads rows*k and writes rows*oc
                # elements, so both must match the buffers exactly —
                # reject any residue rather than over-run
                total = _elems(t_in)
                if total % k != 0 or (total // k) * oc != _elems(t_out):
                    raise NotImplementedError(
                        f"int8-native: FULLY_CONNECTED input "
                        f"{t_in.shape} does not flatten into weight "
                        f"inner dim {k} with output {t_out.shape}; use "
                        "quantized_exec:int8")
                rows = total // k
                mult = (s_in * _per_oc(t_w.scale, oc).astype(np.float64)
                        / s_out).astype(np.float32)
                _ensure_buf(outs[0])
                # FC as a 1x1 conv over an (h=rows, w=1, c=k) image
                prog.add_conv(ins[0], outs[0], 1, rows, 1, k, rows, 1, oc,
                              1, 1, 1, 1, 0, 0,
                              np.ascontiguousarray(w8.T),
                              _per_oc(wzp, oc), bias, mult, xzp, yzp, lo, hi)
                continue
            if tuple(cfg.get("dilation", (1, 1))) != (1, 1):
                raise NotImplementedError(
                    f"int8-native: dilated {code} unsupported; use "
                    "quantized_exec:int8")
            _, h, w, c = t_in.shape
            sh, sw = cfg["strides"]
            if code == "CONV_2D":
                oc, kh, kw, ic = w8.shape
                if ic != c:
                    raise NotImplementedError(
                        "int8-native: grouped CONV_2D unsupported")
                oh, ow, pads = explicit_padding(h, w, kh, kw, (sh, sw),
                                                (1, 1), cfg["padding"])
                mult = (s_in * _per_oc(t_w.scale, oc).astype(np.float64)
                        / s_out).astype(np.float32)
                wkn = np.ascontiguousarray(
                    w8.transpose(1, 2, 3, 0).reshape(kh * kw * ic, oc))
                _ensure_buf(outs[0])
                prog.add_conv(ins[0], outs[0], n, h, w, c, oh, ow, oc, kh,
                              kw, sh, sw, pads[0][0], pads[1][0], wkn,
                              _per_oc(wzp, oc), bias, mult, xzp, yzp, lo, hi)
            else:  # DEPTHWISE_CONV_2D
                _, kh, kw, oc = w8.shape
                if oc != c:
                    raise NotImplementedError(
                        "int8-native: depthwise multiplier != 1; use "
                        "quantized_exec:int8")
                oh, ow, pads = explicit_padding(h, w, kh, kw, (sh, sw),
                                                (1, 1), cfg["padding"])
                mult = (s_in * _per_oc(t_w.scale, c).astype(np.float64)
                        / s_out).astype(np.float32)
                _ensure_buf(outs[0])
                prog.add_dw(ins[0], outs[0], n, h, w, c, oh, ow, kh, kw, sh,
                            sw, pads[0][0], pads[1][0],
                            np.ascontiguousarray(w8.reshape(kh * kw, c)),
                            _per_oc(wzp, c), bias, mult, xzp, yzp, lo, hi)
            continue
        if code == "ADD":
            if ins[0] not in live or ins[1] not in live:
                raise NotImplementedError(
                    "int8-native: ADD with constant operand unsupported")
            # the native kernel reads `elems` bytes from BOTH operands:
            # broadcasting shapes would overread — reject them
            if (tuple(tensors[ins[0]].shape) != tuple(t_out.shape)
                    or tuple(tensors[ins[1]].shape) != tuple(t_out.shape)):
                raise NotImplementedError(
                    "int8-native: broadcasting ADD unsupported "
                    f"({tensors[ins[0]].shape} + {tensors[ins[1]].shape} "
                    f"-> {t_out.shape}); use quantized_exec:int8")
            sa, azp = _u8dom(tensors[ins[0]])
            sb, bzp = _u8dom(tensors[ins[1]])
            s_out, yzp = _u8dom(t_out)
            lo, hi = _bounds_u8(cfg.get("act", _ACT_NONE), s_out, yzp)
            ka, kb = sa / s_out, sb / s_out
            c0 = -(azp * ka + bzp * kb) + yzp
            elems = _elems(t_out)
            _ensure_buf(outs[0])
            prog.add_add(ins[0], ins[1], outs[0], elems,
                         np.float32(ka), np.float32(kb), np.float32(c0),
                         lo, hi)
            continue
        if code in ("AVERAGE_POOL_2D", "MEAN"):
            t_in = tensors[ins[0]]
            s_in, xzp = _u8dom(t_in)
            s_out, yzp = _u8dom(t_out)
            _, h, w, c = t_in.shape
            if code == "MEAN":
                axes = tuple(int(a) for a in
                             np.atleast_1d(raw_consts[ins[1]]).reshape(-1))
                if tuple(sorted(axes)) != (1, 2):
                    raise NotImplementedError(
                        f"int8-native: MEAN over axes {axes}; use "
                        "quantized_exec:int8")
                kh, kw, sh, sw, oh, ow = h, w, 1, 1, 1, 1
                pt = pl = 0
                lo, hi = 0, 255  # MEAN has no fused activation
            else:
                kh, kw = cfg["filter"]
                sh, sw = cfg["strides"]
                oh, ow, pads = explicit_padding(h, w, kh, kw, (sh, sw),
                                                (1, 1), cfg["padding"])
                pt, pl = pads[0][0], pads[1][0]
                lo, hi = _bounds_u8(cfg.get("act", _ACT_NONE), s_out, yzp)
            _ensure_buf(outs[0])
            prog.add_avgpool(ins[0], outs[0], n, h, w, c, oh, ow, kh, kw,
                             sh, sw, pt, pl, xzp,
                             np.float32(s_in / s_out), yzp, lo, hi)
            continue
        if code == "SOFTMAX":
            t_in = tensors[ins[0]]
            s_in, xzp = _u8dom(t_in)
            s_out, yzp = _u8dom(t_out)
            cols = int(t_in.shape[-1])
            rows = _elems(t_in) // cols
            _ensure_buf(outs[0])
            prog.add_softmax(ins[0], outs[0], rows, cols,
                             np.float32(s_in), xzp,
                             np.float32(1.0 / s_out), yzp,
                             np.float32(cfg.get("beta", 1.0)))
            continue
        raise NotImplementedError(
            f"int8-native: builtin op {code} has no native kernel; run "
            "this model with quantized_exec:int8 or fake-quant")

    prog.io(list(in_idx), list(out_idx))

    out_meta = []
    for idx in out_idx:
        t = tensors[idx]
        if len(t.shape) > 0 and t.shape[0] == 1:
            shape = (n,) + tuple(int(d) for d in t.shape[1:])
        else:  # non-relabelable shape: n == 1 guaranteed by _elems
            shape = tuple(int(d) for d in t.shape)
        out_meta.append((idx, t, shape))

    in_elems = [_elems(tensors[idx]) for idx in in_idx]

    def fn(*inputs):
        ins_np = []
        for i, idx in enumerate(in_idx):
            t = tensors[idx]
            x = inputs[i]
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()  # one explicit pull to the host
            x = np.asarray(x)
            if x.size != in_elems[i]:
                # the program's memcpy reads a fixed byte count — reject
                # mismatched frames here
                raise ValueError(
                    f"int8-native: input {i} has {x.size} elements, "
                    f"program expects {in_elems[i]} "
                    f"(batch {n} x {tuple(t.shape[1:])})")
            if np.issubdtype(x.dtype, np.floating):
                s, zp = _u8dom(t)
                q = np.clip(np.rint(x / s) + zp, 0, 255)
                x = q.astype(np.uint8)
            elif t.dtype == np.int8:
                x = (x.astype(np.int16) + 128).astype(np.uint8)
            else:
                x = x.astype(np.uint8)
            ins_np.append(np.ascontiguousarray(x).reshape(-1))
        outs_np = [np.empty(int(np.prod(shape, dtype=np.int64)), np.uint8)
                   for _, _, shape in out_meta]
        prog.run(ins_np, outs_np)
        results = []
        for raw, (_, t, shape) in zip(outs_np, out_meta):
            y = raw.reshape(shape)
            if float_output:
                s, zp = _u8dom(t)
                y = (y.astype(np.float32) - zp) * s
            elif t.dtype == np.int8:
                y = (y.astype(np.int16) - 128).astype(np.int8)
            results.append(y)
        return tuple(results)

    fn.host_native = True
    fn.q8_simd = q8.simd_level()
    fn._q8_program = prog  # keeps the native program alive with the fn
    return fn
