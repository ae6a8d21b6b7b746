"""tensor_aggregator: frame batching / windowing (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_aggregator.c`` — the
reference's only batching primitive: accumulate ``frames-in``-unit frames,
emit ``frames-out`` concatenated along ``frames-dim``, slide by
``frames-flush`` (SURVEY.md §2.3). On the card this is the batcher in
front of the model: N stream frames become one invocation.

Semantics: each input buffer holds ``frames-in`` frames along axis
``frames-dim``. The element re-chunks the stream into output buffers of
``frames-out`` frames, advancing by ``frames-flush`` frames (default:
``frames-out``, i.e. non-overlapping; smaller = sliding window).
``concat=false`` stacks on a new leading axis instead.

Residency: a window of torch tensors stays torch on its device (``cat``
and ``stack`` run there), so a device stream is never pulled to the host.
Once a CUDA frame has entered the window the window stays on that card
and host frames are uploaded into it; an all-numpy stream stays numpy.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
    tensors_info_from_caps,
)
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate


def _join(xs, dim: int, concat: bool, dev: Optional[torch.device]):
    """Concat along ``dim`` or stack on a new leading axis: in numpy for
    an all-numpy window, else on ``dev`` (slices taken before the window
    moved to the card are uploaded; the rest are not copied)."""
    if dev is None:
        return np.concatenate(xs, axis=dim) if concat else np.stack(xs, axis=0)
    # nnlint: disable=NNL402 — host-born frames joining a device window: this
    # upload IS the element's work (as_tensor of a tensor already there is a
    # no-op)
    xs = [torch.as_tensor(x, device=dev) for x in xs]
    return torch.cat(xs, dim=dim) if concat else torch.stack(xs, dim=0)


@register_element
class TensorAggregator(TransformElement):
    ELEMENT_NAME = "tensor_aggregator"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "frames_in": Prop(1, int, "frames per incoming buffer along frames-dim"),
        "frames_out": Prop(1, int, "frames per outgoing buffer"),
        "frames_flush": Prop(0, int, "frames to advance per output (0 = frames-out)"),
        "frames_dim": Prop(0, int, "axis holding the frame dimension"),
        "concat": Prop(True, prop_bool, "concat along frames-dim (else stack new axis)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._window: List[list] = []  # per-frame lists of tensor slices
        # the device of the window once a torch frame entered it (a CUDA
        # device wins over the CPU); None = an all-numpy window
        self._window_device: Optional[torch.device] = None
        self._out_info: Optional[TensorsInfo] = None

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        info = tensors_info_from_caps(caps)
        fi, fo = self.props["frames_in"], self.props["frames_out"]
        dim = self.props["frames_dim"]
        if info.format is not TensorFormat.STATIC or not info.specs:
            self._out_info = TensorsInfo((), TensorFormat.FLEXIBLE)
            return
        specs = []
        for s in info.specs:
            if dim >= len(s.shape):
                raise ElementError(
                    f"{self.describe()}: frames-dim {dim} out of range for {s.describe()}"
                )
            if self.props["concat"]:
                per_frame = s.shape[dim] // max(fi, 1)
                shape = list(s.shape)
                shape[dim] = per_frame * fo
                specs.append(TensorSpec(tuple(shape), s.dtype))
            else:
                specs.append(TensorSpec((fo, *s.shape), s.dtype))
        self._out_info = TensorsInfo.of(*specs)

    def transform_caps(self, src_pad: Pad) -> Caps:
        return caps_from_tensors_info(self._out_info)

    def _latch_device(self, buf: Buffer) -> None:
        for t in buf.tensors:
            if isinstance(t, torch.Tensor) and (
                    self._window_device is None
                    or self._window_device.type == "cpu"):
                self._window_device = t.device

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        fi = max(self.props["frames_in"], 1)
        fo = self.props["frames_out"]
        flush = self.props["frames_flush"] or fo
        dim = self.props["frames_dim"]
        self._latch_device(buf)
        dev = self._window_device
        if dev is not None:
            # host frames joining a torch window are uploaded to its
            # device; a tensor already there is not copied
            # nnlint: disable=NNL402 — host-born frames joining a device
            # window: this upload IS the element's work (as_tensor of a tensor
            # already there is a no-op)
            arrays = [torch.as_tensor(t, device=dev) for t in buf.tensors]
        else:
            arrays = [np.asarray(t) for t in buf.tensors]
        # split the incoming buffer into per-frame slices along frames-dim
        for f in range(fi):
            self._window.append([self._slice_frame(a, f, fi, dim) for a in arrays])
        concat = self.props["concat"]
        while len(self._window) >= fo:
            chunk = self._window[:fo]
            tensors = [_join([c[i] for c in chunk], dim, concat, dev)
                       for i in range(len(arrays))]
            self.push(Buffer(tensors).copy_metadata_from(buf))
            self._window = self._window[flush:]
        return None  # pushes happen inline above

    @staticmethod
    def _slice_frame(a, idx: int, total: int, dim: int):
        size = a.shape[dim] // total
        sl = [slice(None)] * a.ndim
        sl[dim] = slice(idx * size, (idx + 1) * size)
        return a[tuple(sl)]

    def reset_flow(self) -> None:
        super().reset_flow()
        self._window = []
        self._window_device = None

    def handle_eos(self) -> None:
        self._window = []
        super().handle_eos()
