"""tensor_converter: the media→tensor boundary (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_converter.c`` (2433 LoC)
— parses video/x-raw (incl. the width%4 stride-copy caveat, which vanishes
here because frames are numpy arrays, not strided GstMemory), audio/x-raw,
text, octet streams and flexible tensors; chunks ``frames-per-tensor`` media
frames into one tensor frame; delegates unknown media types to converter
subplugins (:1881).

It works on the host, as nnstreamer_tpu's does, and emits host arrays:
media frames are numpy, and a device tensor reaching it is pulled once.
``mode=custom-script:<file.py>`` runs a user python converter
(``converters/python_converter.py``).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
    clock_now,
)
from ..core.caps import (
    AUDIO_MIME,
    OCTET_MIME,
    TENSORS_MIME,
    TEXT_MIME,
    VIDEO_MIME,
    Structure,
)
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..registry.subplugin import SubpluginKind, get as get_subplugin
from ..runtime.element import ElementError, Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger

from ..core.caps import FLATBUF_MIME, FLEXBUF_MIME, PROTOBUF_MIME

# IDL byte-stream MIMEs → the converter subplugin that parses them
# (reference: caps-driven subplugin dispatch of ext/nnstreamer/tensor_converter/)
_IDL_MIMES = {PROTOBUF_MIME: "protobuf", FLATBUF_MIME: "flatbuf",
              FLEXBUF_MIME: "flexbuf"}

_IN_CAPS = Caps(
    tuple(
        Structure.new(m)
        for m in (VIDEO_MIME, AUDIO_MIME, TEXT_MIME, OCTET_MIME, TENSORS_MIME,
                  *_IDL_MIMES)
    )
)

_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "GRAY8": 1, "RGBA": 4, "BGRx": 4, "BGRA": 4}

# reference audio/x-raw sample formats -> numpy dtypes
# (gst_tensor_converter audio path: dtype from format string)
_AUDIO_FORMATS = {
    "S8": np.int8, "U8": np.uint8,
    "S16LE": np.int16, "U16LE": np.uint16,
    "S32LE": np.int32, "U32LE": np.uint32,
    "F32LE": np.float32, "F64LE": np.float64,
}


@register_element
class TensorConverter(TransformElement):
    ELEMENT_NAME = "tensor_converter"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _IN_CAPS),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new(TENSORS_MIME)),)
    DEVICE_AFFINITY = "host"  # media parsing works on host byte layouts
    # barrier text of the fusion planner (runtime/fusion.py)
    FUSION_BARRIER = "host media parsing (byte-layout work in host memory)"
    PROPERTIES = {
        "frames_per_tensor": Prop(1, int, "chunk N media frames into one tensor frame"),
        "input_dim": Prop(None, str, "dim string for octet/text input"),
        "input_type": Prop("uint8", str, "dtype for octet/text input"),
        "subplugin": Prop(None, str, "external converter subplugin name"),
        "set_timestamp": Prop(True, prop_bool,
                              "stamp untimestamped media with running time "
                              "(reference set-timestamp)"),
        "subplugin_option": Prop(None, str,
                                 "option string handed to the subplugin "
                                 "(e.g. python3 converter .py file)"),
        # reference mode property (gsttensor_converter.c): the corpus
        # spells python converters ``mode=custom-script:<path>[:opt]``
        "mode": Prop(None, str,
                     "converter mode: custom-script:<py file>[:option] "
                     "(reference custom-converter idiom) or "
                     "custom-code:<registered name>"),
    }

    READONLY_PROPS = ("sub-plugins",)
    SUBPLUGIN_KIND = SubpluginKind.CONVERTER  # read-only sub-plugins prop

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        # reference expectFail corpus: a malformed or zero dimension in
        # input-dim / an unknown input-type is rejected at property-set
        # time (gst_tensor_converter set_property), not at the first buffer
        dim = self.props["input_dim"]
        if dim is not None:
            try:
                spec = TensorSpec.from_dim_string(dim,
                                                  self.props["input_type"])
            except Exception as e:
                raise ElementError(
                    f"{self.describe()}: bad input-dim='{dim}' "
                    f"input-type='{self.props['input_type']}': {e}")
            if any(d <= 0 for d in spec.shape):
                raise ElementError(
                    f"{self.describe()}: input-dim='{dim}' has a "
                    "non-positive dimension")
        if self.props["frames_per_tensor"] < 1:
            raise ElementError(
                f"{self.describe()}: frames-per-tensor="
                f"{self.props['frames_per_tensor']} must be >= 1")
        self._mode: Optional[str] = None
        self._out_info: Optional[TensorsInfo] = None
        self._pending: List[Buffer] = []
        self._frame_spec: Optional[TensorSpec] = None
        self._ext = None  # external converter subplugin instance
        self._t0: Optional[float] = None  # set-timestamp epoch

    # -- negotiation --------------------------------------------------------
    def set_caps(self, pad: Pad, caps: Caps) -> None:
        s = caps.first
        media = s.media_type
        n = self.props["frames_per_tensor"]
        # IDL streams self-select their converter from the caps MIME, like
        # the reference's query_caps dispatch; an explicit subplugin= or
        # mode= (the reference's custom-converter spelling,
        # gsttensor_converter.c mode property) wins
        subplugin = self.props["subplugin"]
        opt = self.props["subplugin_option"]
        mode = self.props["mode"]
        if mode and not subplugin:
            kind, _, arg = mode.partition(":")
            if kind == "custom-script":
                if not arg:
                    raise ElementError(
                        f"{self.describe()}: mode=custom-script needs a "
                        "script path (custom-script:<file.py>)")
                # custom-script:<path>[:option] — a further ':' separates
                # a trailing option unless the whole arg IS the path.
                # Neither user API (native Converter / reference
                # CustomConverter) takes per-instance options, so a
                # trailing option is accepted-and-logged, not consumed.
                if ":" in arg and not os.path.exists(arg):
                    arg, _, script_opt = arg.partition(":")
                    if script_opt:
                        logger.info(
                            "%s: custom-script option '%s' accepted "
                            "(python converters take no option)",
                            self.describe(), script_opt)
                subplugin, opt = "python3", arg
            elif kind == "custom-code":
                if not arg:
                    raise ElementError(
                        f"{self.describe()}: mode=custom-code needs a "
                        "registered converter name (custom-code:<name>)")
                subplugin = arg
            else:
                raise ElementError(
                    f"{self.describe()}: unknown converter mode '{mode}' "
                    "(custom-script:<file.py> | custom-code:<name>)")
        subplugin = subplugin or _IDL_MIMES.get(media)
        if subplugin:
            cls = get_subplugin(SubpluginKind.CONVERTER, subplugin)
            if not isinstance(cls, type):
                self._ext = cls
            elif opt is not None:
                self._ext = cls(opt)
            else:
                self._ext = cls()
            self._mode = "external"
            self._out_info = self._ext.get_out_info(caps)
            return
        if media == VIDEO_MIME:
            self._mode = "video"
            h, w = s.get("height"), s.get("width")
            c = _VIDEO_CHANNELS.get(s.get("format", "RGB"), 3)
            self._frame_spec = TensorSpec((1, h, w, c), "uint8")
            shape = (n, h, w, c)
            self._out_info = TensorsInfo.of(TensorSpec(shape, "uint8"))
        elif media == AUDIO_MIME:
            # audio frame counts vary per buffer; stream is flexible unless
            # the app constrains it downstream (reference frames-per-buffer).
            # PCM interpretation follows the caps like the reference
            # (gst_tensor_converter audio: dtype from format, dimension
            # channels:frames): raw byte payloads are viewed as the sample
            # dtype and shaped (frames, channels)
            self._mode = "audio"
            self._audio_dtype = _AUDIO_FORMATS.get(
                str(s.get("format", "S16LE")).upper())
            if self._audio_dtype is None:
                raise ElementError(
                    f"{self.describe()}: unsupported audio format "
                    f"'{s.get('format')}' (known: {sorted(_AUDIO_FORMATS)})")
            self._audio_channels = int(s.get("channels", 1) or 1)
            self._out_info = TensorsInfo((), TensorFormat.FLEXIBLE)
        elif media in (TEXT_MIME, OCTET_MIME):
            self._mode = "bytes"
            dim = self.props["input_dim"]
            if dim:
                spec = TensorSpec.from_dim_string(dim, self.props["input_type"])
                self._out_info = TensorsInfo.of(spec)
            else:
                self._out_info = TensorsInfo((), TensorFormat.FLEXIBLE)
        elif media == TENSORS_MIME:
            # flexible tensor input -> static passthrough where possible
            self._mode = "tensors"
            self._out_info = TensorsInfo((), TensorFormat.FLEXIBLE)
        else:
            raise ElementError(f"{self.describe()}: unsupported media '{media}'")

    def transform_caps(self, src_pad: Pad) -> Caps:
        return caps_from_tensors_info(self._out_info)

    # -- chain --------------------------------------------------------------
    def transform(self, buf: Buffer) -> Optional[Buffer]:
        out = self._transform_inner(buf)
        if (out is not None and out.pts is None
                and self.props["set_timestamp"]):
            # reference set-timestamp: stamp untimestamped media with the
            # running clock so downstream sync policies have a pts. Stamped
            # on the OUTPUT buffer — the input may be tee-shared and must
            # not be mutated.
            if self._t0 is None:
                self._t0 = clock_now()
            out.pts = clock_now() - self._t0
        return out

    def _transform_inner(self, buf: Buffer) -> Optional[Buffer]:
        if self._mode == "external":
            return self._ext.convert(buf)
        arrays = [self._to_array(t) for t in buf.as_numpy().tensors]
        n = self.props["frames_per_tensor"]
        if n <= 1:
            out = Buffer(arrays).copy_metadata_from(buf)
            if self._mode == "video":
                out.tensors = [a[None, ...] if a.ndim == 3 else a for a in arrays]
            return out
        # chunking: accumulate n media frames -> one stacked tensor frame
        self._pending.append(Buffer(arrays).copy_metadata_from(buf))
        if len(self._pending) < n:
            return None
        chunk = self._pending
        self._pending = []
        if self._mode == "audio":
            # audio buffers legitimately vary in sample count (the element's
            # own flexible-caps rationale), so chunking CONCATENATES along
            # the frames axis — the reference adapter-accumulates sample
            # frames the same way — instead of stacking equal-shape buffers
            stacked = [
                np.concatenate([c.tensors[i] for c in chunk], axis=0)
                for i in range(chunk[0].num_tensors)
            ]
        else:
            stacked = [
                np.stack([c.tensors[i] for c in chunk], axis=0)
                for i in range(chunk[0].num_tensors)
            ]
        out = Buffer(stacked).copy_metadata_from(chunk[0])
        return out

    def _to_array(self, t) -> np.ndarray:
        if self._mode == "audio":
            a = np.asarray(t)
            if a.dtype != self._audio_dtype:
                if a.dtype != np.uint8:
                    # a typed payload disagreeing with the caps is a caps/
                    # payload mismatch, not bytes to reinterpret — a silent
                    # byte view would turn the samples into garbage
                    raise ElementError(
                        f"{self.describe()}: audio payload dtype {a.dtype} "
                        f"contradicts caps format "
                        f"({np.dtype(self._audio_dtype).name})")
                itemsize = np.dtype(self._audio_dtype).itemsize
                if a.nbytes % itemsize:
                    raise ElementError(
                        f"{self.describe()}: {a.nbytes}B PCM payload not a "
                        f"multiple of the {itemsize}B sample size")
                # raw PCM bytes (filesrc/appsrc payloads): view per caps
                a = a.reshape(-1).view(self._audio_dtype)
            if a.ndim == 1 and self._audio_channels > 1:
                if a.size % self._audio_channels:
                    raise ElementError(
                        f"{self.describe()}: {a.size} samples not divisible "
                        f"by {self._audio_channels} channels")
                a = a.reshape(-1, self._audio_channels)
            return a
        if self._mode == "bytes":
            raw = np.asarray(t).view(np.uint8).reshape(-1)
            dim = self.props["input_dim"]
            if dim:
                spec = TensorSpec.from_dim_string(dim, self.props["input_type"])
                if raw.nbytes != spec.nbytes:
                    raise ElementError(
                        f"{self.describe()}: {raw.nbytes}B payload != declared "
                        f"{spec.nbytes}B ({spec.describe()})"
                    )
                return raw.view(spec.dtype.np_dtype).reshape(spec.shape)
            return raw
        if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
            return t  # numpy has no bfloat16: stays a CPU tensor
        return np.asarray(t)

    def reset_flow(self) -> None:
        super().reset_flow()
        self._pending = []
        self._t0 = None

    def handle_eos(self) -> None:
        # flush partial chunk (reference drops it; we also drop — a partial
        # batch would violate the negotiated static shape)
        self._pending = []
        super().handle_eos()
