"""GStreamer media-element shims: videoconvert / videoscale / imagefreeze /
audiotestsrc / audioconvert. They work on host numpy frames, as in
nnstreamer_tpu; ``videomixer``/``compositor`` and the file decoders
(``pngdec``) are not in this package yet.

The reference's launch lines lean on these GStreamer elements around the
tensor boundary (tests/*/runTest.sh: ``videotestsrc ! videoconvert !
videoscale ! video/x-raw,width=..,format=RGB ! tensor_converter``).
They're not NNStreamer components, but drop-in launch-line compatibility
needs their roles: format conversion, scaling, synthetic audio.

Negotiation note: GStreamer converters derive their output from
DOWNSTREAM caps; our negotiation is push-based, so these shims (and the
test/file sources) read the nearest downstream ``capsfilter`` through
other passthrough shims via :func:`downstream_filter_fields` and adopt
its constraints — which is exactly how the reference pipelines use them
(an explicit caps filter right after the conversion chain).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import Buffer, Caps
from ..core.caps import AUDIO_MIME, VIDEO_MIME, Structure
from ..registry.elements import register_element
from ..utils.log import logger
from ..runtime.element import ElementError, Prop, TransformElement
from ..runtime.pad import Pad, PadDirection, PadTemplate

# elements safe to look THROUGH when searching for the constraining
# capsfilter (passthrough-ish shims + queue). Custom elements can opt in
# by declaring ``CAPS_TRANSPARENT = True`` instead of editing this set.
_TRANSPARENT = {"videoconvert", "videoscale", "audioconvert",
                "imagefreeze", "queue", "tee"}


def downstream_filter_caps(element, max_hops: int = 8) -> Optional[Caps]:
    """The nearest downstream capsfilter's caps, walking through
    caps-transparent elements; None when none is found.

    BOUNDARY (documented contract): the walk follows the FIRST src pad
    only and looks through at most ``max_hops`` elements that are either
    in ``_TRANSPARENT`` or declare ``CAPS_TRANSPARENT = True``. A
    constraint sitting behind any other element is out of reach — the
    caller falls back to its defaults, and the walk logs where it
    stopped so the fallback is visible, not silent. GStreamer's real
    negotiation propagates caps through every element; these shims only
    need the reference's launch-line idioms (capsfilter right after the
    src, possibly behind convert/scale/rate/queue), so a bounded,
    logged walk is the deliberate trade.
    """
    cur = element
    for _ in range(max_hops):
        pads = getattr(cur, "src_pads", ())
        if not pads or pads[0].peer is None:
            # chain ends (or isn't linked yet) before any capsfilter —
            # the no-capsfilter default case; debug, not info: this is
            # the normal launch shape, not a missed constraint
            logger.debug(
                "%s: downstream chain ends before a capsfilter — "
                "using defaults", getattr(element, "name", element))
            return None
        nxt = pads[0].peer.element
        filter_caps = getattr(nxt, "filter_caps", None)
        if filter_caps is not None:  # capsfilter (duck-typed: no import cycle)
            return filter_caps
        if (getattr(nxt, "ELEMENT_NAME", None) not in _TRANSPARENT
                and not getattr(nxt, "CAPS_TRANSPARENT", False)):
            logger.info(
                "%s: downstream capsfilter search stopped at opaque "
                "element '%s' — using defaults (place the capsfilter "
                "directly downstream, or mark the element "
                "CAPS_TRANSPARENT)",
                getattr(element, "name", element),
                getattr(nxt, "name", nxt))
            return None
        cur = nxt
    logger.info(
        "%s: no capsfilter within %d downstream hops — using defaults",
        getattr(element, "name", element), max_hops)
    return None


def downstream_filter_fields(element, max_hops: int = 8) -> Dict[str, object]:
    """Fields of the nearest downstream capsfilter (see
    :func:`downstream_filter_caps`). Empty dict when none is found."""
    caps = downstream_filter_caps(element, max_hops)
    if caps is None:
        return {}
    return {k: v for k, v in caps.first.fields}


# -- video ------------------------------------------------------------------

_TO_RGB = {
    "RGB": lambda a: a,
    "BGR": lambda a: a[..., ::-1],
    "GRAY8": lambda a: np.repeat(a, 3, axis=-1),
    "RGBA": lambda a: a[..., :3],
    "BGRA": lambda a: a[..., 2::-1],
    "BGRx": lambda a: a[..., 2::-1],
}


def _from_rgb(rgb: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "RGB":
        return rgb
    if fmt == "BGR":
        return rgb[..., ::-1]
    if fmt == "GRAY8":
        luma = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2])
        return np.clip(luma, 0, 255).astype(np.uint8)[..., None]
    if fmt in ("RGBA", "BGRA", "BGRx"):
        rgb3 = rgb if fmt == "RGBA" else rgb[..., ::-1]
        alpha = np.full(rgb.shape[:-1] + (1,), 255, np.uint8)
        return np.concatenate([rgb3, alpha], axis=-1)
    raise ElementError(f"videoconvert: unknown target format '{fmt}'")


class _VideoShim(TransformElement):
    """Shared negotiation: remember the input video structure, expose the
    (possibly rewritten) output structure."""

    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK,
                                  Caps.new(VIDEO_MIME)),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC,
                                 Caps.new(VIDEO_MIME)),)

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._in_fields: Dict[str, object] = {}

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._in_fields = {k: v for k, v in caps.first.fields}

    def _out_fields(self) -> Dict[str, object]:  # overridden
        return dict(self._in_fields)

    def transform_caps(self, src_pad: Pad) -> Caps:
        return Caps((Structure(VIDEO_MIME,
                               tuple(self._out_fields().items())),))


@register_element
class VideoConvert(_VideoShim):
    """Pixel-format conversion (GStreamer ``videoconvert`` role): target
    format from the nearest downstream capsfilter, passthrough otherwise."""

    ELEMENT_NAME = "videoconvert"

    def _target(self) -> Optional[str]:
        return downstream_filter_fields(self).get("format")

    def _out_fields(self) -> Dict[str, object]:
        out = dict(self._in_fields)
        tgt = self._target()
        if tgt:
            out["format"] = tgt
        return out

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        src_fmt = self._in_fields.get("format", "RGB")
        tgt = self._target() or src_fmt
        if tgt == src_fmt:
            return buf
        if src_fmt not in _TO_RGB:
            raise ElementError(
                f"{self.describe()}: unknown source format '{src_fmt}'")
        frames = []
        for t in buf.as_numpy().tensors:
            a = np.asarray(t)
            squeeze = a.ndim == 2
            if squeeze:
                a = a[..., None]
            frames.append(_from_rgb(
                np.ascontiguousarray(_TO_RGB[src_fmt](a)).astype(np.uint8),
                tgt))
        return Buffer(frames).copy_metadata_from(buf)


@register_element
class VideoScale(_VideoShim):
    """Frame resize (GStreamer ``videoscale`` role): target size from the
    nearest downstream capsfilter; nearest-neighbor sampling."""

    ELEMENT_NAME = "videoscale"

    def _target(self):
        f = downstream_filter_fields(self)
        return f.get("width"), f.get("height")

    def _out_fields(self) -> Dict[str, object]:
        out = dict(self._in_fields)
        w, h = self._target()
        if w:
            out["width"] = w
        if h:
            out["height"] = h
        return out

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        w, h = self._target()
        if not w and not h:
            return buf
        frames = []
        for t in buf.as_numpy().tensors:
            a = np.asarray(t)
            ih, iw = a.shape[0], a.shape[1]
            oh, ow = int(h or ih), int(w or iw)
            if (oh, ow) == (ih, iw):
                frames.append(a)
                continue
            yi = (np.arange(oh) * ih // oh).clip(0, ih - 1)
            xi = (np.arange(ow) * iw // ow).clip(0, iw - 1)
            frames.append(np.ascontiguousarray(a[yi][:, xi]))
        return Buffer(frames).copy_metadata_from(buf)


@register_element
class ImageFreeze(TransformElement):
    """GStreamer ``imagefreeze`` slot-in. SIMPLIFIED: the real element
    turns one image into an endless fixed-framerate video stream; here it
    passes frames through unchanged (the reference pipelines bound their
    streams elsewhere, and a per-frame passthrough keeps frame counts
    equal to what the upstream file sequence provides)."""

    ELEMENT_NAME = "imagefreeze"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK,
                                  Caps.new(VIDEO_MIME)),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC,
                                 Caps.new(VIDEO_MIME)),)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        return buf


# -- audio ------------------------------------------------------------------

# audio caps format <-> numpy dtype + full-scale for float conversion
_AUDIO_FMTS = {
    "S8": (np.int8, 128.0), "U8": (np.uint8, None),
    "S16LE": (np.int16, 32768.0), "S32LE": (np.int32, 2147483648.0),
    "F32LE": (np.float32, 1.0), "F64LE": (np.float64, 1.0),
}


from .src import _PacedSource  # noqa: E402


@register_element
class AudioTestSrc(_PacedSource):
    """Synthetic audio source (GStreamer ``audiotestsrc`` role): a sine
    wave; format/rate/channels adopted from the nearest downstream
    capsfilter (the reference idiom: ``audiotestsrc ! audioconvert !
    audio/x-raw,format=S16LE,rate=8000 ! tensor_converter``)."""

    ELEMENT_NAME = "audiotestsrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC,
                                 Caps.new(AUDIO_MIME)),)
    PROPERTIES = {
        "samplesperbuffer": Prop(1024, int, "samples per output buffer"),
        "freq": Prop(440.0, float, "sine frequency Hz"),
        "volume": Prop(0.8, float, "amplitude 0..1"),
        "rate": Prop(44100, int, "sample rate (downstream caps override)"),
        "format": Prop("S16LE", str, "sample format (downstream caps override)"),
        "channels": Prop(1, int, "channels (downstream caps override)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._sample_pos = 0

    def reset_flow(self) -> None:
        super().reset_flow()
        self._sample_pos = 0

    def _config(self):
        hint = downstream_filter_fields(self)
        fmt = str(hint.get("format", self.props["format"]))
        rate = int(hint.get("rate", self.props["rate"]) or self.props["rate"])
        ch = int(hint.get("channels", self.props["channels"])
                 or self.props["channels"])
        if fmt not in _AUDIO_FMTS:
            raise ElementError(
                f"{self.describe()}: unsupported format '{fmt}' "
                f"(known: {sorted(_AUDIO_FMTS)})")
        return fmt, rate, ch

    def get_src_caps(self) -> Caps:
        fmt, rate, ch = self._config()
        return Caps.new(AUDIO_MIME, format=fmt, rate=rate, channels=ch)

    def create(self) -> Optional[Buffer]:
        kw = self._pace()
        if kw is None:
            return None
        fmt, rate, ch = self._config()
        n = self.props["samplesperbuffer"]
        t = (self._sample_pos + np.arange(n)) / rate
        self._sample_pos += n
        wave = np.sin(2 * np.pi * self.props["freq"] * t) * self.props["volume"]
        if ch > 1:
            wave = np.repeat(wave[:, None], ch, axis=1)
        dt, scale = _AUDIO_FMTS[fmt]
        if scale is None:  # U8: biased
            samples = ((wave * 127) + 128).clip(0, 255).astype(np.uint8)
        elif np.issubdtype(dt, np.floating):
            samples = wave.astype(dt)
        else:
            samples = (wave * (scale - 1)).astype(dt)
        return Buffer([samples], **kw)


@register_element
class AudioConvert(TransformElement):
    """Sample-format conversion (GStreamer ``audioconvert`` role): target
    format from the nearest downstream capsfilter, with proper full-scale
    rescaling between integer and float sample domains."""

    ELEMENT_NAME = "audioconvert"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK,
                                  Caps.new(AUDIO_MIME)),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC,
                                 Caps.new(AUDIO_MIME)),)

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._in_fields: Dict[str, object] = {}

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._in_fields = {k: v for k, v in caps.first.fields}

    def _target(self) -> Optional[str]:
        return downstream_filter_fields(self).get("format")

    def transform_caps(self, src_pad: Pad) -> Caps:
        out = dict(self._in_fields)
        tgt = self._target()
        if tgt:
            out["format"] = tgt
        return Caps((Structure(AUDIO_MIME, tuple(out.items())),))

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        src_fmt = str(self._in_fields.get("format", "S16LE"))
        tgt = self._target() or src_fmt
        if tgt == src_fmt:
            return buf
        if src_fmt not in _AUDIO_FMTS or tgt not in _AUDIO_FMTS:
            raise ElementError(
                f"{self.describe()}: cannot convert '{src_fmt}' -> '{tgt}'")
        _, s_scale = _AUDIO_FMTS[src_fmt]
        dt, t_scale = _AUDIO_FMTS[tgt]
        out = []
        for t in buf.as_numpy().tensors:
            a = np.asarray(t)
            f = (a.astype(np.float64) - 128.0) / 128.0 if s_scale is None \
                else a.astype(np.float64) / s_scale
            if t_scale is None:
                out.append(((f * 127) + 128).clip(0, 255).astype(np.uint8))
            elif np.issubdtype(dt, np.floating):
                out.append(f.astype(dt))
            else:
                out.append((f.clip(-1, 1) * (t_scale - 1)).astype(dt))
        return Buffer(out).copy_metadata_from(buf)
