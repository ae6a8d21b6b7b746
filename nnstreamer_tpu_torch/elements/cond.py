"""tensor_if: data-dependent control flow inside the pipeline (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_if.c`` (1212 LoC) —
compared-value (A_VALUE / TENSOR_TOTAL_VALUE / TENSOR_AVERAGE_VALUE / CUSTOM,
gsttensor_if.h:42-55), 10 operators (:60-72), then/else behaviors (:79-91)
including PASSTHROUGH / SKIP / FILL_ZERO / FILL_VALUES / TENSORPICK, and
registerable python callback conditions (custom_cb_s :112).

The counterpart of nnstreamer_tpu's ``elements/cond.py``. The decision is a
host scalar per frame (the reference does the same): on a CUDA tensor
``a-value`` gathers one element on its card and the total/average reduce
in float32 there, so one scalar crosses per buffer; host tensors reduce in
float64. The fill actions keep a CUDA tensor on its card.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps
from ..core.buffer import (_is_device_array, bf16_bits, bf16_from_bits,
                           is_host_bf16)
from ..core.data import parse_number
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, TransformElement
from ..runtime.pad import Pad, PadDirection, PadPresence, PadTemplate

_custom_conditions: Dict[str, Callable] = {}


def register_if_condition(name: str, fn: Callable[[Buffer], bool]) -> None:
    """Register a python condition callback (reference
    ``gst_tensor_if_register_custom_callback``)."""
    _custom_conditions[name] = fn


def unregister_if_condition(name: str) -> bool:
    return _custom_conditions.pop(name, None) is not None


_OPERATORS = {
    "eq": lambda v, a: v == a[0],
    "ne": lambda v, a: v != a[0],
    "gt": lambda v, a: v > a[0],
    "ge": lambda v, a: v >= a[0],
    "lt": lambda v, a: v < a[0],
    "le": lambda v, a: v <= a[0],
    "range-inclusive": lambda v, a: a[0] <= v <= a[1],
    "range-exclusive": lambda v, a: a[0] < v < a[1],
    "not-in-range-inclusive": lambda v, a: not (a[0] <= v <= a[1]),
    "not-in-range-exclusive": lambda v, a: not (a[0] < v < a[1]),
}


def _host(t) -> np.ndarray:
    """A host view of ``t`` for host-side fills (a CUDA tensor's one
    copy down happens here, only on the fill-with-file path); a bfloat16
    tensor, which numpy lacks, as its uint16 bit patterns."""
    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bfloat16:
            return bf16_bits(t)
        return t.cpu().numpy()
    return np.asarray(t)


def _full_like(t, v):
    """``np.full_like``'s cast of ``v`` into ``t``'s dtype, made on the
    card for a CUDA tensor (through a host scalar of that dtype, so both
    paths cast the same way)."""
    if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
        return torch.full_like(t, float(v))  # numpy has no bfloat16
    if _is_device_array(t):
        dt = np.dtype(str(t.dtype).removeprefix("torch."))
        return torch.full_like(t, np.asarray(v).astype(dt).item())
    return np.full_like(_host(t), v)


@register_element
class TensorIf(TransformElement):
    """Branch the stream on a per-buffer condition. Precision note:
    `tensor-total-value`/`tensor-average-value` reduce device-resident
    buffers in float32 ON the accelerator (only the scalar crosses D2H)
    but host-resident buffers in float64 — the compared value can differ
    in the last bits depending on where the buffer lives, so `eq`/`ne`
    compare with a small relative tolerance (1e-6) on the device path
    and threshold operators (`gt`/`lt`/...) should not be aimed exactly
    at a value the reduction computes. `a-value` reads one element with
    no accumulation and is exact on both paths.

    Reference analog: gsttensor_if.c (which is host-only and always
    f64-exact; the residency dependence is nnstreamer_tpu's, bought for
    keeping the branch decision on the device, and the port keeps it)."""

    ELEMENT_NAME = "tensor_if"
    # fusion barrier (runtime/fusion.py): the branch decision is a
    # per-buffer HOST scalar — routing cannot live inside a CUDA graph
    FUSION_BARRIER = "tensor_if dynamic routing (per-buffer branch decision)"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    # static "src" merges both branches onto one stream; the reference
    # instead creates src_%d pads on demand with THEN routed to src_0 and
    # ELSE to src_1 (gsttensor_if.c TIFSP_THEN_PAD/TIFSP_ELSE_PAD,
    # gst_tensor_if_get_tensor_pad) — the corpus's ``tif.src_0 !`` /
    # ``tif.src_1 !`` spelling requests exactly those
    SRC_TEMPLATES = (
        PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),
        PadTemplate("src_%u", PadDirection.SRC, Caps.new("other/tensors"),
                    PadPresence.REQUEST),
    )
    PROPERTIES = {
        "compared_value": Prop("a-value", str,
                               "a-value | tensor-total-value | "
                               "tensor-average-value | custom "
                               "(total/average reduce in f32 on device "
                               "buffers vs f64 on host — see precision "
                               "note above)"),
        "compared_value_option": Prop("0", str,
                                      "a-value: 'tensorIdx:flatIdx'; total/average: tensor idx; custom: registered name"),
        "operator": Prop("gt", str, "|".join(_OPERATORS)),
        "supplied_value": Prop("0", str, "comparison value(s), ':'-separated for ranges"),
        "then": Prop("passthrough", str,
                     "passthrough | skip | fill-zero | fill-values | "
                     "tensorpick | fill-with-file | fill-with-file-rpt | "
                     "repeat-previous"),
        "then_option": Prop(None, str,
                            "fill value / tensor indices / raw tensor file "
                            "path (fill-with-file*)"),
        "else": Prop("skip", str, "same choices as then"),
        "else_option": Prop(None, str, "same roles as then-option"),
    }

    # -- negotiation --------------------------------------------------------
    _BRANCHES = (("then", "then_option"), ("else", "else_option"))

    def _branch_selection(self, action_key: str, option_key: str):
        """Tensor indices a branch emits: list = tensorpick subset, None =
        full set, 'inherit' = no shape of its own (skip/repeat-previous)."""
        action = self.props[action_key]
        if action in ("skip", "repeat-previous"):
            return "inherit"
        if action == "tensorpick":
            return [int(p) for p in str(self.props[option_key] or "0").split(",")]
        return None

    def transform_caps(self, src_pad):
        """tensorpick changes the stream's tensor count — src caps must
        reflect it (reference adjusts caps for TENSORPICK). On the merged
        static ``src`` all emitting branches must agree; the reference's
        dynamic pads (``src_0`` = then, ``src_1`` = else,
        gsttensor_if.c TIFSP_*_PAD) each carry their own branch's shape."""
        from ..core import TensorsInfo, caps_from_tensors_info, tensors_info_from_caps

        in_caps = self.sink_pads[0].caps
        then_sel = self._branch_selection(*self._BRANCHES[0])
        else_sel = self._branch_selection(*self._BRANCHES[1])
        if src_pad.name == "src_0":
            # skip emits nothing (caps moot); repeat-previous re-emits
            # whatever the other branch shaped
            picks = then_sel if then_sel != "inherit" else else_sel
            picks = None if picks == "inherit" else picks
        elif src_pad.name == "src_1":
            picks = else_sel if else_sel != "inherit" else then_sel
            picks = None if picks == "inherit" else picks
        else:
            # merged single-src: emitting branches must agree
            selections = [s for s in (then_sel, else_sel) if s != "inherit"]
            if len(set(map(repr, selections))) > 1:
                raise ElementError(
                    f"{self.describe()}: then/else branches emit different "
                    "tensor selections; caps would be inconsistent"
                )
            picks = selections[0] if selections else None
        if picks is None:
            return in_caps
        info = tensors_info_from_caps(in_caps)
        return caps_from_tensors_info(TensorsInfo.of(*(info.specs[i] for i in picks)))

    # -- condition ----------------------------------------------------------
    # equality tolerance for the device reduce path: its f32 accumulation
    # legitimately differs from the host's f64 in the last bits, so an
    # exact eq/ne there would branch on buffer RESIDENCY (docs/elements.md)
    _DEVICE_EQ_RTOL = 1e-6

    def _compared_value(self, buf: Buffer):
        """Returns (value, approx): approx marks the device total/average
        reduction, whose f32 accumulation is not bit-identical to the
        host's f64 path — equality operators then compare with a small
        tolerance instead of branching on residency."""
        kind = self.props["compared_value"]
        opt = self.props["compared_value_option"]
        if kind == "custom":
            fn = _custom_conditions.get(opt)
            if fn is None:
                raise ElementError(f"{self.describe()}: no custom condition '{opt}'")
            return fn(buf), False
        if kind == "a-value":
            t_idx, _, flat_idx = opt.partition(":")
            t = buf.tensors[int(t_idx or 0)]
            if _is_device_array(t):
                # gather ONE element on the card; only the scalar crosses
                # D2H (a full pull here would ship the whole tensor per
                # frame at every branch point). A single element is
                # exact — no accumulation, no tolerance.
                return float(t.reshape(-1)[int(flat_idx or 0)]), False
            if isinstance(t, torch.Tensor):
                return float(t.reshape(-1)[int(flat_idx or 0)]), False
            return float(np.asarray(t).reshape(-1)[int(flat_idx or 0)]), False
        t = buf.tensors[int(opt or 0)]
        if _is_device_array(t):
            # reduce on the card in float32 (the host path keeps its f64
            # exactness), pull the scalar
            if kind in ("tensor-total-value", "tensor-average-value"):
                t32 = t.to(torch.float32)
                red = t32.sum() if kind == "tensor-total-value" \
                    else t32.mean()
                return float(red), True
            raise ElementError(
                f"{self.describe()}: unknown compared-value '{kind}'")
        if isinstance(t, torch.Tensor):
            t = t.to(torch.float64).numpy()
        t = np.asarray(t, dtype=np.float64)
        if kind == "tensor-total-value":
            return float(t.sum()), False
        if kind == "tensor-average-value":
            return float(t.mean()), False
        raise ElementError(f"{self.describe()}: unknown compared-value '{kind}'")

    def _evaluate(self, buf: Buffer) -> bool:
        kind = self.props["compared_value"]
        value, approx = self._compared_value(buf)
        if kind == "custom":
            return bool(value)
        op = self.props["operator"]
        if op not in _OPERATORS:
            raise ElementError(f"{self.describe()}: unknown operator '{op}'")
        supplied = [parse_number(p) for p in str(self.props["supplied_value"]).split(":")]
        if approx and op in ("eq", "ne"):
            scale = max(1.0, abs(value), abs(float(supplied[0])))
            equal = abs(value - float(supplied[0])) \
                <= self._DEVICE_EQ_RTOL * scale
            return equal if op == "eq" else not equal
        return _OPERATORS[op](value, supplied)

    # -- actions ------------------------------------------------------------
    def _apply(self, action: str, option, buf: Buffer) -> Optional[Buffer]:
        if action == "passthrough":
            return buf
        if action == "skip":
            return None
        if action == "fill-zero":
            return buf.with_tensors(
                [torch.zeros_like(t) if _is_device_array(t) or is_host_bf16(t)
                 else np.zeros_like(_host(t)) for t in buf.tensors]
            ).copy_metadata_from(buf)
        if action == "fill-values":
            v = parse_number(str(option or "0"))
            return buf.with_tensors(
                [_full_like(t, v) for t in buf.tensors]
            ).copy_metadata_from(buf)
        if action == "tensorpick":
            idx = [int(p) for p in str(option or "0").split(",")]
            return buf.with_tensors([buf.tensors[i] for i in idx]).copy_metadata_from(buf)
        if action in ("fill-with-file", "fill-with-file-rpt"):
            # declared-but-unimplemented in the reference (gsttensor_if.h:84-87
            # enum with no .c handler); implemented here per its header docs:
            # output tensors filled from the file's raw bytes — short files
            # zero-fill the rest (plain) or repeat cyclically (rpt)
            data = self._fill_file_bytes(str(option or ""))
            out, off = [], 0
            for t in buf.tensors:
                a = _host(t)
                n = a.nbytes
                if action == "fill-with-file-rpt" and len(data):
                    start = off % len(data)
                    tiled = np.tile(data, n // len(data) + 2)
                    chunk = tiled[start:start + n]
                else:
                    avail = data[off:off + n]
                    chunk = np.zeros(n, np.uint8)
                    chunk[:len(avail)] = avail
                off += n
                filled = chunk.view(a.dtype).reshape(a.shape)
                if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
                    filled = bf16_from_bits(filled).to(t.device)
                elif _is_device_array(t):
                    filled = torch.from_numpy(filled.copy()).to(t.device)
                out.append(filled)
            return buf.with_tensors(out).copy_metadata_from(buf)
        if action == "repeat-previous":
            # reference TIFB_REPEAT_PREVIOUS_FRAME: re-emit the last frame
            # this element produced; nothing cached yet -> skip
            prev = getattr(self, "_prev_out", None)
            if prev is None:
                return None
            return prev.with_tensors(list(prev.tensors)).copy_metadata_from(buf)
        raise ElementError(f"{self.describe()}: unknown action '{action}'")

    def _fill_file_bytes(self, path: str) -> np.ndarray:
        if not path:
            raise ElementError(
                f"{self.describe()}: fill-with-file needs the branch option "
                "to name the raw tensor file")
        cached = getattr(self, "_fill_cache", None)
        if cached is None or cached[0] != path:
            with open(path, "rb") as fh:
                self._fill_cache = (path, np.frombuffer(fh.read(), np.uint8))
        return self._fill_cache[1]

    def reset_flow(self) -> None:
        super().reset_flow()
        self._prev_out = None

    def _branch_pad(self, nth: int) -> Optional[Pad]:
        for p in self.src_pads:
            if p.name == f"src_{nth}":
                return p
        return None

    def chain(self, pad: Pad, buf: Buffer) -> None:
        """Route per branch when dedicated pads were requested (reference
        chain: THEN → src_0, ELSE → src_1); merged static src otherwise."""
        cond = self._evaluate(buf)
        action_key, option_key = self._BRANCHES[0 if cond else 1]
        out = self._apply(self.props[action_key], self.props[option_key], buf)
        if out is not None:
            self._prev_out = out
        if out is None:
            return
        branch = self._branch_pad(0 if cond else 1)
        if branch is not None:
            if branch.is_linked:
                branch.push(out)
            return
        if self._branch_pad(1 if cond else 0) is not None:
            return  # split mode, this branch's pad never requested: drop
        self.push(out)
