"""tensor_merge / tensor_split: axis-wise concat and slice (L3).

Reference analogs: ``gsttensor_merge.c`` (891 LoC — N single-tensor streams →
1 tensor by concatenating along an axis, same sync policies as mux) and
``gsttensor_split.c`` (725 LoC — slice one tensor into several along an axis,
``tensorseg`` sizes). These are the reference's manual tensor-parallelism
primitives (SURVEY.md §2.9: TP ≈ split → filters → merge). The counterpart
of nnstreamer_tpu's ``elements/mergesplit.py``: a merge with any part on a
card is one ``torch.cat`` on that card (stray host parts are copied up),
an all-host merge is a numpy concatenate; a split of a CUDA tensor slices
views on its card.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    TensorsInfo,
    caps_from_tensors_info,
    tensors_info_from_caps,
)
from ..core.buffer import _is_device_array, as_torch
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..runtime.element import Element, ElementError, Prop
from ..runtime.pad import Pad, PadDirection, PadPresence, PadTemplate
from .muxdemux import collect_sync


@register_element
class TensorMerge(Element):
    """Concatenate one tensor from each sink pad along ``option`` axis
    (reference mode=linear)."""

    ELEMENT_NAME = "tensor_merge"
    SINK_TEMPLATES = (
        PadTemplate("sink_%u", PadDirection.SINK, Caps.new("other/tensors"),
                    PadPresence.REQUEST),
    )
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "mode": Prop("linear", str, "only 'linear' (axis concat) exists"),
        "option": Prop(0, int, "concat axis"),
        "sync_mode": Prop("slowest", str,
                          "slowest | nosync | basepad | refresh (reference "
                          "sync policies, tensor_mux semantics)"),
        "sync_option": Prop(None, str, "basepad: base sink index[:max pts gap s]"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._queues: Dict[str, List[Buffer]] = {}
        self._latest: Dict[str, Buffer] = {}
        self._merge_lock = threading.Lock()

    def reset_flow(self) -> None:
        super().reset_flow()
        with self._merge_lock:
            self._queues.clear()
            self._latest.clear()

    def transform_caps(self, src_pad: Pad) -> Caps:
        axis = self.props["option"]
        specs = [tensors_info_from_caps(p.caps).specs[0] for p in self.sink_pads
                 if p.is_linked]
        base = list(specs[0].shape)
        for s in specs[1:]:
            if len(s.shape) != len(base):
                raise ElementError(f"{self.describe()}: rank mismatch")
            base[axis] += s.shape[axis]
        return caps_from_tensors_info(
            TensorsInfo.of(TensorSpec(tuple(base), specs[0].dtype))
        )

    def chain(self, pad: Pad, buf: Buffer) -> None:
        with self._merge_lock:
            parts = collect_sync(self, pad, buf)
            if parts is None:
                return
        axis = self.props["option"]
        # device residency: parts on a card concatenate there, so
        # filter→merge chains never bounce through the host
        dev = next((p.tensors[0].device for p in parts
                    if _is_device_array(p.tensors[0])), None)
        if dev is not None:
            merged = torch.cat([_on(p.tensors[0], dev) for p in parts],
                               dim=axis)
        else:
            merged = np.concatenate(
                [np.asarray(p.tensors[0]) for p in parts], axis=axis)
        out = Buffer([merged]).copy_metadata_from(parts[0])
        out.pts = max((p.pts for p in parts if p.pts is not None), default=None)
        self.push(out)


def _on(t, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: a tensor already there as is; a stray host part
    copied up — asynchronously only from pinned memory, where the copy
    cannot race a later write to the source."""
    t = as_torch(t)
    if t.device == dev:
        return t
    return t.to(dev, non_blocking=t.is_pinned())


@register_element
class TensorSplit(Element):
    """Slice the single input tensor along an axis into per-pad chunks.

    ``tensorseg``: ','-separated chunk sizes along the axis ("2,2,4");
    without it the tensor is split evenly across linked src pads.
    """

    ELEMENT_NAME = "tensor_split"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (
        PadTemplate("src_%u", PadDirection.SRC, Caps.new("other/tensors"),
                    PadPresence.REQUEST),
    )
    PROPERTIES = {
        "axis": Prop(0, int, "split axis"),
        "tensorseg": Prop(None, str, "chunk sizes along axis, ','-separated"),
        # reference tensorpick: emit only the chosen segment indices, in
        # order, one per linked src pad
        "tensorpick": Prop(None, str, "segment indices to emit (default all)"),
    }

    def _picked(self, nsegs: int) -> List[int]:
        v = self.props["tensorpick"]
        if not v:
            return list(range(nsegs))
        if not self.props["tensorseg"]:
            raise ElementError(
                f"{self.describe()}: tensorpick needs tensorseg to define "
                "the segments being picked")
        picks = [int(p) for p in str(v).split(",") if p.strip()]
        for p in picks:
            if not 0 <= p < nsegs:
                raise ElementError(
                    f"{self.describe()}: tensorpick {p} out of range "
                    f"({nsegs} segments)")
        linked = len(self._linked_pads())
        if linked and len(picks) != linked:
            raise ElementError(
                f"{self.describe()}: tensorpick selects {len(picks)} "
                f"segments but {linked} src pads are linked")
        return picks

    def _segments(self, total: int) -> List[int]:
        v = self.props["tensorseg"]
        if v:
            segs = [int(p) for p in str(v).split(",")]
            if sum(segs) != total:
                raise ElementError(
                    f"{self.describe()}: tensorseg {segs} != axis size {total}"
                )
            return segs
        n = len([p for p in self.src_pads if p.is_linked]) or 1
        if total % n:
            raise ElementError(f"{self.describe()}: axis {total} not divisible by {n} pads")
        return [total // n] * n

    def _linked_pads(self) -> List[Pad]:
        return [p for p in self.src_pads if p.is_linked]

    def transform_caps(self, src_pad: Pad) -> Caps:
        info = tensors_info_from_caps(self.sinkpad.caps)
        spec = info.specs[0]
        axis = self.props["axis"]
        segs = self._segments(spec.shape[axis])
        idx = self._linked_pads().index(src_pad)
        seg_idx = self._picked(len(segs))[idx]
        shape = list(spec.shape)
        shape[axis] = segs[seg_idx]
        return caps_from_tensors_info(
            TensorsInfo.of(TensorSpec(tuple(shape), spec.dtype))
        )

    def chain(self, pad: Pad, buf: Buffer) -> None:
        axis = self.props["axis"]
        # torch tensors slice as views where they lie (a CUDA tensor on
        # its card, no D2H); other host arrays as numpy views
        a = buf.tensors[0]
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        segs = self._segments(a.shape[axis])
        offsets = [sum(segs[:i]) for i in range(len(segs))]
        picked = self._picked(len(segs))
        for seg_idx, src in zip(picked, self._linked_pads()):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(offsets[seg_idx], offsets[seg_idx] + segs[seg_idx])
            src.push(Buffer([a[tuple(sl)]]).copy_metadata_from(buf))
