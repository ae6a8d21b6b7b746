"""tensor_transform: elementwise stream transforms (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_transform.c`` (2202 LoC)
with modes dimchg/typecast/arithmetic/transpose/stand/clamp (+padding). The
ORC SIMD acceleration (``acceleration`` prop) is replaced by PyTorch ops on
the element's device; the property is accepted and ignored.

Device rule: a CUDA tensor is transformed where it lies; a host array (a
numpy array or a CPU tensor) is first copied to the device that
``accelerator`` names (``auto`` = ``cuda:0``), so a uint8 frame batch
crosses to the card before it is widened to float32. Every output stays
on its device, the tensors ``apply`` leaves out too (as nnstreamer_tpu's
jitted call returns them). Output caps come from running the mode on
``device="meta"`` tensors of the negotiated specs, which gives
nnstreamer_tpu's dtypes (ops/transform_ops.py: 64-bit types become 32-bit
ones).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import (
    Buffer,
    Caps,
    DataType,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
    tensors_info_from_caps,
)
from ..core.buffer import as_torch
from ..core.tensors import TensorSpec
from ..ops.transform_ops import canonicalize, parse_transform_options
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.hw_accel import device_for_accelerator


@register_element
class TensorTransform(TransformElement):
    ELEMENT_NAME = "tensor_transform"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    DEVICE_AFFINITY = "device"  # elementwise torch ops on the card
    # reference read-only constant (gsttensor_transform.c
    # transpose-rank-limit): max rank the transpose option string addresses
    TRANSPOSE_RANK_LIMIT = 4
    READONLY_PROPS = ("transpose-rank-limit",)

    def get_property(self, key: str):
        if key.replace("-", "_") == "transpose_rank_limit":
            return self.TRANSPOSE_RANK_LIMIT
        return super().get_property(key)

    PROPERTIES = {
        "mode": Prop(None, str, "dimchg|typecast|arithmetic|transpose|stand|clamp|padding"),
        "option": Prop("", str, "mode-specific option string"),
        # reference `apply`: comma-separated tensor indices the transform
        # applies to (others pass through untouched); default all
        "apply": Prop(None, str, "tensor indices to apply to (default all)"),
        # reference `acceleration` toggles ORC SIMD; accepted for
        # launch-line compatibility, ignored
        "acceleration": Prop(True, prop_bool,
                             "accepted for reference compat (ignored)"),
        "accelerator": Prop("auto", str,
                            "device host arrays are copied to before the "
                            "transform: auto | gpu | cuda[:N] | cpu (auto "
                            "and gpu = cuda:0); CUDA inputs stay where "
                            "they are"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["mode"]:
            raise ElementError(f"{self.describe()}: 'mode' property required")
        self._fn: Callable = parse_transform_options(
            self.props["mode"], self.props["option"]
        )
        apply_s = self.props["apply"]
        self._apply = (None if not apply_s else
                       {int(v) for v in str(apply_s).split(",") if v.strip()})
        self._device: Optional[torch.device] = None
        self._out_info: Optional[TensorsInfo] = None

    def _applies(self, i: int) -> bool:
        return self._apply is None or i in self._apply

    def _run(self, xs) -> list:
        # every tensor takes nnstreamer_tpu's dtype, as its jitted call
        # gives it; only the applied ones are transformed
        xs = [canonicalize(x) for x in xs]
        return [self._fn(x) if self._applies(i) else x
                for i, x in enumerate(xs)]

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        in_info = tensors_info_from_caps(caps)
        if (self._apply and in_info.format is TensorFormat.STATIC
                and in_info.specs):
            bad = [i for i in self._apply if not 0 <= i < len(in_info.specs)]
            if bad:
                raise ElementError(
                    f"{self.describe()}: apply={sorted(bad)} out of range "
                    f"for a {len(in_info.specs)}-tensor stream")
        # a missing card fails here, at negotiation, on the bus
        self._device = device_for_accelerator(self.props["accelerator"])
        if in_info.format is TensorFormat.STATIC and in_info.specs:
            metas = [torch.empty(s.shape, dtype=s.dtype.torch_dtype,
                                 device="meta") for s in in_info.specs]
            outs = self._run(metas)
            self._out_info = TensorsInfo.of(
                *(TensorSpec(tuple(o.shape), DataType.from_any(o.dtype))
                  for o in outs))
        else:
            self._out_info = TensorsInfo((), in_info.format)

    def transform_caps(self, src_pad: Pad) -> Caps:
        if self._out_info is None:
            raise ElementError(f"{self.describe()}: not negotiated")
        return caps_from_tensors_info(self._out_info)

    def _place(self, x) -> torch.Tensor:
        x = as_torch(x)
        return x if x.is_cuda else x.to(self._device)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        if self._device is None:  # negotiation failed or never happened
            raise ElementError(f"{self.describe()}: not negotiated")
        outs = self._run([self._place(x) for x in buf.tensors])
        return Buffer(outs).copy_metadata_from(buf)

    # -- segment fusion (runtime/fusion.py) ---------------------------------
    def fusion_stage(self):
        """The raw per-tensor transform, composed into the segment's one
        dispatch. The ``_place`` copy stays outside: the segment moves
        its inputs to its device once, before the stages run."""
        if self._device is None:
            return None
        fn = self._fn
        applies = self._applies

        def stage(xs):
            xs = [canonicalize(x) for x in xs]
            return tuple(fn(x) if applies(i) else x
                         for i, x in enumerate(xs))
        return stage

    def fusion_host_device(self) -> Optional[torch.device]:
        """Where a fused segment headed by this transform moves host
        inputs (``accelerator``); CUDA inputs stay where they lie."""
        return self._device
