"""File-feeding sources and image decode.

Reference analogs: GStreamer ``filesrc`` / ``multifilesrc`` — the standard
fixture feeders of every reference SSAT pipeline (e.g.
``multifilesrc location=tensors.0.%d caps=application/octet-stream !
tensor_converter input-dim=... input-type=...``,
tests/nnstreamer_decoder_boundingbox/runTest.sh) — and the ``pngdec``
role (compressed image bytes → raw video frame), gated on Pillow.

Both sources default to ``application/octet-stream`` caps so a
downstream ``tensor_converter input-dim=... input-type=...`` gives the
bytes their tensor shape, exactly like the reference pipelines. The
counterpart of nnstreamer_tpu's ``elements/files.py``: everything here
runs on the host.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core import Buffer, Caps, parse_caps_string
from ..core.caps import (OCTET_MIME, VIDEO_MIME, Structure,
                         any_media_caps)
from ..registry.elements import register_element
from ..runtime.element import Element, ElementError, Prop, SourceElement
from ..runtime.pad import Pad, PadDirection, PadTemplate

_OCTET_CAPS = Caps.new(OCTET_MIME)


class _FileSourceBase(SourceElement):
    """Shared bits of filesrc/multifilesrc: required location, optional
    caps override (template must stay open for the override to link —
    the AppSrc pattern)."""

    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, any_media_caps()),)
    PROPERTIES = {
        "location": Prop(None, str, "file path / printf-style pattern"),
        "caps": Prop(None, lambda v: v, "override output caps string"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.props["location"]:
            raise ElementError(f"{self.describe()}: location is required")

    def get_src_caps(self) -> Caps:
        if self.props["caps"]:
            return parse_caps_string(self.props["caps"])
        # like GStreamer's caps-any filesrc, the downstream capsfilter
        # decides what the bytes ARE (reference idiom: filesrc !
        # image/x-portable-graymap,... ! pnmdec), looked up through
        # transparent shims/queues
        from .media import downstream_filter_caps

        filter_caps = downstream_filter_caps(self)
        if filter_caps is not None:
            return filter_caps
        return _OCTET_CAPS


@register_element
class FileSrc(_FileSourceBase):
    """Single-file source: pushes the file's bytes, then EOS.

    ``blocksize`` splits the file into chunks (-1 = whole file in one
    buffer, the reference tests' ``blocksize=-1`` idiom). The file is
    opened once and read sequentially (no per-buffer reopen races).
    """

    ELEMENT_NAME = "filesrc"
    PROPERTIES = {
        "blocksize": Prop(-1, int, "bytes per buffer (<0 = whole file)"),
        # the reference's SSAT lines pass num_buffers on filesrc (its
        # repo-source idiom); honor it as a read cap (0 = unbounded)
        "num_buffers": Prop(0, int, "stop after N buffers (0 = all)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["blocksize"] == 0:
            raise ElementError(
                f"{self.describe()}: blocksize must be nonzero "
                "(use -1 for the whole file)")
        self._fh = None
        self._offset = 0

    def reset_flow(self) -> None:
        super().reset_flow()
        self._close()
        self._offset = 0

    def _close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None

    def stop(self) -> None:
        super().stop()
        self._close()

    def create(self) -> Optional[Buffer]:
        n_max = self.props["num_buffers"]
        if n_max > 0 and self._offset >= n_max:  # <=0 = unbounded (gst)
            self._close()
            return None
        path = self.props["location"]
        if self._fh is None:
            try:
                self._fh = open(path, "rb")
            except OSError as e:
                raise ElementError(
                    f"{self.describe()}: cannot open '{path}': {e}")
        block = self.props["blocksize"]
        data = self._fh.read() if block < 0 else self._fh.read(block)
        if not data:  # EOF — forward progress guaranteed: read(n>0) or EOF
            self._close()
            return None
        # offset is the CHUNK sequence number (Buffer.offset is a frame
        # counter consumed by e.g. shard re-join, not a byte position)
        buf = Buffer([np.frombuffer(data, np.uint8)], offset=self._offset)
        self._offset += 1
        return buf


@register_element
class MultiFileSrc(_FileSourceBase):
    """Per-frame file source: ``location`` is a printf-style pattern
    (``frame.%d``, ``out_%03d.raw``); one file becomes one buffer.

    ``start-index``/``stop-index`` bound the range (stop -1 = until the
    first missing file), matching the reference tests' usage. A location
    with no ``%``-conversion requires an explicit ``stop-index`` (the
    same fixed file each frame) — otherwise it's almost certainly a
    pattern typo and would stream forever.
    """

    ELEMENT_NAME = "multifilesrc"
    PROPERTIES = {
        "start_index": Prop(0, int, "first index"),
        "index": Prop(None, int, "GStreamer spelling of start-index"),
        "stop_index": Prop(-1, int, "last index (-1 = until missing file)"),
        # one file = one buffer here; GStreamer's chunked reads don't
        # apply, but the reference's launch lines pass the property
        "blocksize": Prop(-1, int, "accepted for compat (files are read "
                                   "whole per buffer)"),
        "num_buffers": Prop(0, int, "stop after N buffers (0 = all)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if self.props["index"] is not None:  # GStreamer spelling wins
            self.props["start_index"] = self.props["index"]
        pattern = self.props["location"]
        try:
            self._literal = (pattern % 0) == (pattern % 1)
        except TypeError as e:
            if "not all arguments converted" in str(e):
                self._literal = True  # no conversion specifier at all
            else:
                # e.g. "%d_%d": has conversions but needs >1 argument —
                # a malformed pattern, not a literal filename
                raise ElementError(
                    f"{self.describe()}: location pattern '{pattern}' needs "
                    f"exactly one integer conversion ({e})")
        except ValueError as e:
            raise ElementError(
                f"{self.describe()}: bad location pattern '{pattern}' ({e}); "
                "escape literal percent signs as %%")
        if self._literal and self.props["stop_index"] < 0 \
                and self.props["num_buffers"] <= 0:
            raise ElementError(
                f"{self.describe()}: location '{pattern}' has no %d "
                "conversion — set stop-index or num-buffers for a "
                "fixed-file stream, or fix the pattern")
        self._index = self.props["start_index"]

    def reset_flow(self) -> None:
        super().reset_flow()
        self._index = self.props["start_index"]

    def create(self) -> Optional[Buffer]:
        stop = self.props["stop_index"]
        if stop >= 0 and self._index > stop:
            return None
        n_max = self.props["num_buffers"]
        if n_max > 0 and self._index - self.props["start_index"] >= n_max:
            return None
        pattern = self.props["location"]
        path = pattern if self._literal else pattern % self._index
        if not os.path.exists(path):
            if stop >= 0:
                raise ElementError(
                    f"{self.describe()}: missing '{path}' before stop-index")
            return None  # open-ended range: first gap is EOS
        with open(path, "rb") as fh:
            data = fh.read()
        buf = Buffer([np.frombuffer(data, np.uint8)],
                     offset=self._index - self.props["start_index"])
        self._index += 1
        return buf


_IMAGE_ACCUM_MAX = 128 << 20  # refuse to buffer more than 128 MB of stream

# signature → (end-of-image marker, trailing bytes after the marker).
# PNG: IEND chunk = len(4) + "IEND" + CRC(4) → image ends 8 bytes past the
# marker start; JPEG: EOI = FFD9, ends with it. Used both to avoid
# re-attempting a full decode on every chunk (quadratic otherwise) and to
# split concatenated image streams at the right byte.
_END_MARKERS = {
    b"\x89PNG\r\n\x1a\n": (b"IEND", 8),
    b"\xff\xd8": (b"\xff\xd9", 2),
}


@register_element
class ImageDec(Element):
    """Compressed image bytes (png/jpeg/bmp…) → ``video/raw`` RGB frame.

    The reference pipelines lean on GStreamer's ``pngdec``; here Pillow
    plays that role (gated: a clear error at construction when absent).
    Like pngdec this parses a byte STREAM: chunked upstream delivery
    (``filesrc blocksize=N``) accumulates until an end-of-image marker
    arrives, concatenated PNG/JPEG streams split into successive frames,
    and EOS with undecodable leftover bytes is an error, not a silent
    drop. Formats without a known end marker decode whole-buffer.
    """

    ELEMENT_NAME = "imagedec"
    # accepts raw byte streams AND image-typed caps (the reference lines
    # put e.g. image/png or image/x-portable-graymap filters before the
    # decoder; Pillow sniffs the actual codec from the bytes)
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps(tuple(
        Structure.new(m) for m in (
            OCTET_MIME, "image/png", "image/jpeg", "image/bmp",
            "image/x-portable-graymap", "image/x-portable-pixmap",
            "image/x-portable-anymap")))),)
    SRC_TEMPLATES = (PadTemplate(
        "src", PadDirection.SRC, Caps.new(VIDEO_MIME, format="RGB")),)

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        try:
            from PIL import Image  # noqa: F401
        except ImportError as e:
            raise ElementError(
                f"{self.describe()}: Pillow is required for image decode "
                f"({e}); feed raw video instead")
        self._pending = bytearray()
        self._pending_meta: Optional[Buffer] = None
        self._scan_from = 0  # resume marker search here (no rescans)

    def reset_flow(self) -> None:
        super().reset_flow()
        self._pending.clear()
        self._pending_meta = None
        self._scan_from = 0

    def transform_caps(self, src_pad: Pad) -> Caps:
        return Caps.new(VIDEO_MIME, format="RGB")

    def _decode_bytes(self, data: bytes):
        import io

        from PIL import Image

        try:
            img = Image.open(io.BytesIO(data))
            return np.asarray(img.convert("RGB"), np.uint8)
        except Exception:
            return None

    def _emit(self, frame: np.ndarray) -> None:
        out = Buffer([frame])
        if self._pending_meta is not None:
            out.copy_metadata_from(self._pending_meta)
        self._pending_meta = None
        self.push(out)

    def _drain(self, at_eos: bool) -> None:
        while self._pending:
            marker = None
            for sig, m in _END_MARKERS.items():
                if self._pending.startswith(sig):
                    marker = m
                    break
            if marker is None:
                # unknown container: no split knowledge — try the whole
                # accumulation (per-buffer images / exotic formats)
                frame = self._decode_bytes(bytes(self._pending))
                if frame is not None:
                    self._pending.clear()
                    self._scan_from = 0
                    self._emit(frame)
                return
            end_tag, tail = marker
            # scan forward from where the last search stopped; a marker hit
            # that fails to decode (e.g. embedded-thumbnail EOI) moves the
            # scan window past it and waits for the true end
            while True:
                i = self._pending.find(end_tag, self._scan_from)
                if i < 0:
                    self._scan_from = max(0, len(self._pending) - len(end_tag) + 1)
                    return  # incomplete: wait for more bytes
                end = i + tail
                if end > len(self._pending):
                    self._scan_from = i
                    return  # marker tail not fully arrived yet
                frame = self._decode_bytes(bytes(self._pending[:end]))
                if frame is not None:
                    del self._pending[:end]
                    self._scan_from = 0
                    self._emit(frame)
                    break  # outer loop: maybe another image follows
                self._scan_from = i + 1  # false marker: keep looking
                if at_eos:
                    continue
                return

    def chain(self, pad: Pad, buf: Buffer) -> None:
        if not self._pending:
            self._pending_meta = buf
        self._pending += bytes(np.asarray(buf.as_numpy().tensors[0]).reshape(-1))
        if len(self._pending) > _IMAGE_ACCUM_MAX:
            raise ElementError(
                f"{self.describe()}: {len(self._pending)} bytes buffered "
                "without a decodable image — not an image stream?")
        self._drain(at_eos=False)

    def handle_eos(self) -> None:
        self._drain(at_eos=True)
        if self._pending:
            raise ElementError(
                f"{self.describe()}: stream ended with {len(self._pending)} "
                "undecodable bytes")
        self.send_eos()


@register_element
class PngDec(ImageDec):
    """GStreamer ``pngdec`` name for :class:`ImageDec` — reference launch
    lines (`... ! pngdec ! ...`) run unchanged."""

    ELEMENT_NAME = "pngdec"


@register_element
class PnmDec(ImageDec):
    """GStreamer ``pnmdec`` name for :class:`ImageDec` (Pillow decodes
    PGM/PPM/PNM the same way)."""

    ELEMENT_NAME = "pnmdec"
