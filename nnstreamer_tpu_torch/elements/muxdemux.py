"""tensor_mux / tensor_demux: combine/split multi-tensor frames (L3).

Reference analogs: ``gsttensor_mux.c`` (662 LoC — N streams → 1 multi-tensor
frame, sync policies nosync/slowest/basepad/refresh from
tensor_common.h:62-68) and ``gsttensor_demux.c`` (682 LoC — 1 multi-tensor
stream → N streams with ``tensorpick`` reordering). The counterpart of
nnstreamer_tpu's ``elements/muxdemux.py``: both move tensor references
only, so CUDA tensors pass through on their card, never copied.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Dict, List, Optional

from ..core import (
    Buffer,
    Caps,
    Event,
    EventType,
    TensorsInfo,
    caps_from_tensors_info,
    tensors_info_from_caps,
)
from ..registry.elements import register_element
from ..runtime.element import Element, ElementError, Prop
from ..runtime.pad import Pad, PadDirection, PadPresence, PadTemplate


@register_element
class TensorMux(Element):
    """N tensor streams → one frame carrying all tensors.

    Sync policies (reference tensor_common.h:62-68):
      * ``slowest`` (default) / ``nosync``: one frame from every pad per
        output (queue-per-pad, pop one each — the pipeline advances at the
        slowest producer);
      * ``basepad``: emit on every frame of the base pad (``sync-option``
        selects which, reference ``sink_id[:duration]``; default 0),
        combining the most recent frame from the other pads — frames are
        skipped when a companion's latest lags the base by more than the
        optional max pts gap;
      * ``refresh``: emit whenever *any* pad receives, reusing the last frame
        from the others.
    """

    ELEMENT_NAME = "tensor_mux"
    # fusion barrier (runtime/fusion.py): N-way fan-in synchronization
    FUSION_BARRIER = "mux fan-in (cross-stream synchronization)"
    SINK_TEMPLATES = (
        PadTemplate("sink_%u", PadDirection.SINK, Caps.new("other/tensors"),
                    PadPresence.REQUEST),
    )
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "sync_mode": Prop("slowest", str, "slowest | nosync | basepad | refresh"),
        # reference sync-option for basepad: "sink_id[:duration]" — which
        # pad drives emission, and (our redesign of the GstCollectPads
        # base_time window) the max pts distance in SECONDS another pad's
        # latest frame may lag before the output frame is skipped
        "sync_option": Prop(None, str, "basepad: base sink index[:max pts gap s]"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._queues: Dict[str, List[Buffer]] = {}
        self._latest: Dict[str, Buffer] = {}
        self._mux_lock = threading.Lock()

    def reset_flow(self) -> None:
        super().reset_flow()
        with self._mux_lock:
            self._queues.clear()
            self._latest.clear()

    def transform_caps(self, src_pad: Pad) -> Caps:
        specs = []
        for pad in self.sink_pads:
            info = tensors_info_from_caps(pad.caps)
            specs.extend(info.specs)
        return caps_from_tensors_info(TensorsInfo.of(*specs))

    def chain(self, pad: Pad, buf: Buffer) -> None:
        with self._mux_lock:
            parts = collect_sync(self, pad, buf)
            if parts is None:
                return
        tensors = [t for part in parts for t in part.tensors]
        out = Buffer(tensors).copy_metadata_from(parts[0])
        # timestamp = latest of the combined frames (reference collects pts)
        out.pts = max((p.pts for p in parts if p.pts is not None), default=None)
        self.push(out)


def _basepad_option(el) -> tuple:
    """Parsed-once (base_idx, max_gap) from sync-option; malformed values
    fail at first use with one clear error, not per-buffer."""
    cached = getattr(el, "_basepad_opt_cache", None)
    if cached is not None:
        return cached
    base_idx, max_gap = 0, None
    opt = el.props["sync_option"]
    if opt:
        try:
            parts_opt = str(opt).split(":", 1)
            base_idx = int(parts_opt[0]) if parts_opt[0] else 0
            if len(parts_opt) > 1 and parts_opt[1]:
                max_gap = float(parts_opt[1])
        except ValueError:
            raise ValueError(
                f"sync-option '{opt}' is not 'sink_id[:max_gap_s]'")
    el._basepad_opt_cache = (base_idx, max_gap)
    return el._basepad_opt_cache


def collect_sync(el, pad: Pad, buf: Buffer):
    """Shared N-pad synchronization (reference sync policies, used by
    tensor_mux AND tensor_merge): returns the per-pad buffer list to
    combine, or None when this arrival doesn't complete a frame. Caller
    holds the element's lock. Needs ``el._queues``/``el._latest`` dicts
    and the sync_mode/sync_option props."""
    mode = el.props["sync_mode"]
    el._latest[pad.name] = buf
    linked = [p for p in el.sink_pads if p.is_linked]
    if mode in ("slowest", "nosync"):
        el._queues.setdefault(pad.name, []).append(buf)
        if not all(el._queues.get(p.name) for p in linked):
            return None
        return [el._queues[p.name].pop(0) for p in linked]
    if mode == "basepad":
        base_idx, max_gap = _basepad_option(el)
        if not 0 <= base_idx < len(linked):
            raise ValueError(
                f"sync-option base index {base_idx} out of range "
                f"({len(linked)} linked pads)")
        if pad is not linked[base_idx]:
            return None
        parts = [el._latest.get(p.name) for p in linked]
        if any(p is None for p in parts):
            return None
        if max_gap is not None and buf.pts is not None:
            for part in parts:
                if part.pts is not None and abs(part.pts - buf.pts) > max_gap:
                    return None  # stale companion: skip this output frame
        return parts
    if mode == "refresh":
        parts = [el._latest.get(p.name) for p in linked]
        return None if any(p is None for p in parts) else parts
    raise ValueError(f"unknown sync-mode '{mode}'")


@register_element
class TensorDemux(Element):
    """One multi-tensor stream → N streams.

    ``tensorpick`` (reference prop) assigns tensors to src pads:
    "0,2" → pad0 gets tensor0, pad1 gets tensor2; "0:1,2" → pad0 gets
    tensors 0+1, pad1 gets tensor 2. Default: pad i gets tensor i.
    """

    ELEMENT_NAME = "tensor_demux"
    # fusion barrier (runtime/fusion.py): request-pad fan-out
    FUSION_BARRIER = "demux fan-out (per-pad tensor routing)"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (
        PadTemplate("src_%u", PadDirection.SRC, Caps.new("other/tensors"),
                    PadPresence.REQUEST),
    )
    PROPERTIES = {
        "tensorpick": Prop(None, str, "per-pad tensor indices, ','-separated"),
    }

    def _picks(self) -> Optional[List[List[int]]]:
        v = self.props["tensorpick"]
        if not v:
            return None
        return [[int(i) for i in part.split(":")] for part in str(v).split(",")]

    def transform_caps(self, src_pad: Pad) -> Caps:
        info = tensors_info_from_caps(self.sinkpad.caps)
        idx = self.src_pads.index(src_pad)
        picks = self._picks()
        sel = picks[idx] if picks else [idx]
        try:
            specs = [info.specs[i] for i in sel]
        except IndexError:
            raise ElementError(
                f"{self.describe()}: pad {idx} picks {sel} from "
                f"{info.num_tensors}-tensor stream"
            )
        return caps_from_tensors_info(TensorsInfo.of(*specs))

    def chain(self, pad: Pad, buf: Buffer) -> None:
        picks = self._picks()
        for idx, src in enumerate(self.src_pads):
            if not src.is_linked:
                continue
            sel = picks[idx] if picks else [idx]
            out = Buffer([buf.tensors[i] for i in sel]).copy_metadata_from(buf)
            src.push(out)
