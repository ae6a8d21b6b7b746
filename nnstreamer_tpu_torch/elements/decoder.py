"""tensor_decoder: the tensor→media boundary (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_decoder.c`` — looks
up a decoder subplugin by ``mode=``, passes ``option1..optionN`` strings,
negotiates output caps from the subplugin, and per-buffer calls its
``decode``. Decoder subplugins live in ``nnstreamer_tpu_torch.decoders``.

With ``frames-in=N`` each incoming buffer is a batch of N frames along
its leading axis (an upstream ``tensor_aggregator``). A batch of torch
tensors is reduced where it lies (on the card for CUDA tensors) by the
decoder's ``make_reduce`` and crosses to the host in one pull; host
batches are split and decoded frame by frame.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import Buffer, Caps, TensorsInfo, tensors_info_from_caps
from ..core.caps import any_media_caps
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..registry.subplugin import SubpluginKind, get as get_subplugin
from ..runtime.element import ElementError, Prop, TransformElement
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger

_N_OPTIONS = 12  # the reference's option numbering, per mode

# distinct batch signatures after which the reduce path warns once
_SIGNATURE_WARN = 32


def _option_props():
    props = {"mode": Prop(None, str, "decoder subplugin name"),
             "frames_in": Prop(1, int,
                               "frames batched along the leading axis of "
                               "each incoming buffer (an upstream "
                               "tensor_aggregator batch decodes in ONE "
                               "device reduction and is emitted as "
                               "frames-in per-frame media buffers)")}
    for i in range(1, _N_OPTIONS + 1):
        props[f"option{i}"] = Prop(
            None, str, f"decoder option #{i} (the reference numbering per mode)")
    return props


def _is_torch_batch(buf: Buffer) -> bool:
    return bool(buf.tensors) and all(isinstance(t, torch.Tensor)
                                     for t in buf.tensors)


@register_element
class TensorDecoder(TransformElement):
    ELEMENT_NAME = "tensor_decoder"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, any_media_caps()),)
    DEVICE_AFFINITY = "host"  # media rendering happens on host memory
    PROPERTIES = _option_props()

    SUBPLUGIN_KIND = SubpluginKind.DECODER  # read-only sub-plugins prop

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        mode = self.props["mode"]
        if not mode:
            raise ElementError(f"{self.describe()}: 'mode' property required")
        cls = get_subplugin(SubpluginKind.DECODER, mode)
        self.decoder = cls() if isinstance(cls, type) else cls
        options = [self.props[f"option{i}"] for i in range(1, _N_OPTIONS + 1)]
        self.decoder.init(options)
        if self.props["frames_in"] < 1:
            raise ElementError(f"{self.describe()}: frames-in must be >= 1")
        self._in_info: Optional[TensorsInfo] = None
        self._frame_info: Optional[TensorsInfo] = None
        self._reduce = None  # (fn,) — built lazily per caps
        self._reduce_sigs: set = set()
        self._sig_warned = False

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._in_info = tensors_info_from_caps(caps)
        self._frame_info = self._per_frame_info(self._in_info)
        self._reduce = None

    def _per_frame_info(self, info: TensorsInfo) -> TensorsInfo:
        """Strip the frames-in batch from the leading axis of each spec —
        the decoder subplugin always negotiates/decodes per frame."""
        fi = self.props["frames_in"]
        if fi == 1 or not info.specs:
            return info
        specs = []
        for s in info.specs:
            if not s.shape or s.shape[0] % fi:
                raise ElementError(
                    f"{self.describe()}: frames-in={fi} does not divide "
                    f"leading dim of {s.describe()}")
            specs.append(TensorSpec((s.shape[0] // fi, *s.shape[1:]), s.dtype))
        return TensorsInfo.of(*specs)

    def transform_caps(self, src_pad: Pad) -> Caps:
        out = self.decoder.get_out_caps(self._frame_info)
        if out is None:
            raise ElementError(
                f"{self.describe()}: decoder rejects input {self._frame_info.describe()}"
            )
        return out

    def _push_decoded(self, out: Optional[Buffer], src: Buffer) -> None:
        if out is None:
            return
        decoder_meta = out.meta  # decode() results must survive the metadata copy
        out.copy_metadata_from(src)
        out.meta.update(decoder_meta)
        self.push(out)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        fi = self.props["frames_in"]
        if fi > 1:
            # static caps are validated at negotiation (_per_frame_info);
            # flexible streams must not silently drop/misalign rows
            for t in buf.tensors:
                if t.shape[0] % fi:
                    raise ElementError(
                        f"{self.describe()}: frames-in={fi} does not divide "
                        f"leading dim {t.shape[0]} of incoming tensor")
        # at frames-in=1 the device reduction engages only for decoders
        # whose leading-dim meaning is unambiguous (FI1_DEVICE_REDUCE —
        # image_labeling opts out: its decode() gives a (B, C) buffer the
        # legacy one-buffer-of-B-labels meaning and must see it unchanged)
        reduce_fn = (self._get_reduce()
                     if fi > 1 or getattr(self.decoder,
                                          "FI1_DEVICE_REDUCE", False)
                     else None)
        if reduce_fn is not None and _is_torch_batch(buf):
            # ONE reduction over the whole batch where it lies, ONE small
            # pull to the host, then per-frame host rendering
            self._track_signature(buf)
            with torch.inference_mode():
                reduced = [a.cpu().numpy() for a in reduce_fn(list(buf.tensors))]
            for f in range(fi):
                out = self.decoder.decode_reduced(
                    [a[f] for a in reduced], self._frame_info)
                self._push_decoded(out, buf)
            return
        host = buf.as_numpy()
        if fi == 1:
            self._push_decoded(
                self.decoder.decode(host, self._frame_info), buf)
            return
        for f in range(fi):  # host batch: split and decode per frame
            frame = Buffer([t[f * (t.shape[0] // fi):(f + 1) * (t.shape[0] // fi)]
                            for t in host.tensors])
            self._push_decoded(
                self.decoder.decode(frame, self._frame_info), buf)

    def _track_signature(self, buf: Buffer) -> None:
        """A flexible stream that pushes a new shape with every buffer
        defeats batching upstream: warn once at 32 distinct signatures so
        the user buckets shapes (tensor_aggregator)."""
        sig = tuple((tuple(t.shape), t.dtype) for t in buf.tensors)
        if sig in self._reduce_sigs:
            return
        self._reduce_sigs.add(sig)
        if len(self._reduce_sigs) >= _SIGNATURE_WARN and not self._sig_warned:
            self._sig_warned = True
            logger.warning(
                "%s: device reduction saw %d distinct input signatures — "
                "a flexible stream changes shape per buffer; bucket "
                "shapes upstream (tensor_aggregator)",
                self.describe(), len(self._reduce_sigs))

    def _get_reduce(self):
        """The decoder's reduction for the current caps, built lazily. It
        reshapes the concat-batched layout (fi*d0, ...) to (fi, ...) when
        the frame's own leading dim d0 is 1 (the common NHWC case), else
        to (fi, d0, ...), so reduce always sees axis 0 = batch over
        frames."""
        if self._reduce is not None:
            return self._reduce[0]
        maker = getattr(self.decoder, "make_reduce", None)  # duck-typed
        fn = maker(self._frame_info) if maker is not None else None
        if fn is None:
            self._reduce = (None,)
            return None
        fi = self.props["frames_in"]

        def batched(tensors):
            split = []
            for t in tensors:
                d0 = t.shape[0] // fi
                split.append(t.reshape(fi, *t.shape[1:]) if d0 == 1
                             else t.reshape(fi, d0, *t.shape[1:]))
            return fn(split)

        self._reduce = (batched,)
        return batched
