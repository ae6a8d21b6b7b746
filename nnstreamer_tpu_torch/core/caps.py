"""Stream capabilities ("caps") and negotiation algebra (L1).

The reference gets caps negotiation from GStreamer (``GstCaps``/``GstStructure``,
intersect/fixate, used throughout e.g. ``gst/nnstreamer/nnstreamer_plugin_api_impl.c``
``gst_tensors_config_from_caps``). We supply that layer ourselves: a ``Caps`` is
an ordered list of ``Structure`` alternatives; a ``Structure`` is a media-type
plus constrained fields. Field constraints are concrete values, ``ValueList``
(choice sets), ``IntRange``, or ``ANY``.

Media types (reference caps names, tensor_typedef.h:46-79):
  * ``other/tensors``        — tensor streams (format static/flexible/sparse)
  * ``video/raw``            — raw video (reference ``video/x-raw``)
  * ``audio/raw``            — raw audio  (reference ``audio/x-raw``)
  * ``text/plain``, ``application/octet-stream`` — text / opaque bytes
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from .tensors import TensorFormat, TensorsInfo

TENSORS_MIME = "other/tensors"
VIDEO_MIME = "video/raw"
AUDIO_MIME = "audio/raw"
TEXT_MIME = "text/plain"
OCTET_MIME = "application/octet-stream"


class _Any:
    """Wildcard field value."""

    _inst: "_Any" = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "ANY"


ANY = _Any()


@dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int  # inclusive

    def __contains__(self, v) -> bool:
        return isinstance(v, int) and self.lo <= v <= self.hi

    def intersect(self, other):
        if isinstance(other, IntRange):
            lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
            if lo > hi:
                return None
            return lo if lo == hi else IntRange(lo, hi)
        if isinstance(other, ValueList):
            return other.intersect(self)  # keep intersection symmetric
        if other in self:
            return other
        return None

    def fixate(self):
        return self.lo

    def __repr__(self):
        return f"[{self.lo},{self.hi}]"


@dataclass(frozen=True)
class ValueList:
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))

    def __contains__(self, v) -> bool:
        return v in self.values

    def intersect(self, other):
        if isinstance(other, ValueList):
            common = tuple(v for v in self.values if v in other.values)
            if not common:
                return None
            return common[0] if len(common) == 1 else ValueList(common)
        if isinstance(other, IntRange):
            common = tuple(v for v in self.values if v in other)
            if not common:
                return None
            return common[0] if len(common) == 1 else ValueList(common)
        if other in self.values:
            return other
        return None

    def fixate(self):
        return self.values[0]

    def __repr__(self):
        return "{" + ",".join(str(v) for v in self.values) + "}"


def _intersect_value(a, b):
    """Intersect two field constraints; None means empty intersection."""
    if a is ANY:
        return b
    if b is ANY:
        return a
    if isinstance(a, (IntRange, ValueList)):
        return a.intersect(b)
    if isinstance(b, (IntRange, ValueList)):
        return b.intersect(a)
    if a == b:
        return a
    # Launch-string fields are weakly typed: "dimensions=2" parses as int 2
    # while an element emits the dim *string* "2". Compare string forms before
    # declaring a mismatch.
    if type(a) is not type(b) and str(a) == str(b):
        return a
    return None


def _is_fixed_value(v) -> bool:
    return not isinstance(v, (IntRange, ValueList, _Any))


@dataclass(frozen=True)
class Structure:
    """One caps alternative: media type + fields."""

    media_type: str
    fields: tuple = ()  # tuple of (key, value) pairs, insertion-ordered

    @classmethod
    def new(cls, media_type: str, **fields) -> "Structure":
        return cls(media_type, tuple(fields.items()))

    def as_dict(self) -> dict:
        return dict(self.fields)

    def get(self, key, default=None):
        for k, v in self.fields:
            if k == key:
                return v
        return default

    def with_fields(self, **updates) -> "Structure":
        d = self.as_dict()
        d.update(updates)
        return Structure(self.media_type, tuple(d.items()))

    def intersect(self, other: "Structure") -> Optional["Structure"]:
        if self.media_type != other.media_type:
            return None
        out = {}
        d1, d2 = self.as_dict(), other.as_dict()
        for k in {**d1, **d2}:
            a, b = d1.get(k, ANY), d2.get(k, ANY)
            v = _intersect_value(a, b)
            if v is None:
                return None
            if v is not ANY:
                out[k] = v
        return Structure(self.media_type, tuple(out.items()))

    @property
    def is_fixed(self) -> bool:
        return all(_is_fixed_value(v) for _, v in self.fields)

    def fixate(self) -> "Structure":
        out = []
        for k, v in self.fields:
            if isinstance(v, (IntRange, ValueList)):
                v = v.fixate()
            elif v is ANY:
                continue
            out.append((k, v))
        return Structure(self.media_type, tuple(out))

    def __str__(self):
        parts = [self.media_type]
        for k, v in self.fields:
            parts.append(f"{k}={v}")
        return ",".join(parts)


@dataclass(frozen=True)
class Caps:
    """Ordered list of ``Structure`` alternatives (GstCaps analog)."""

    structures: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "structures", tuple(self.structures))

    @classmethod
    def new(cls, media_type: str, **fields) -> "Caps":
        return cls((Structure.new(media_type, **fields),))

    @classmethod
    def any_of(cls, *structures: Structure) -> "Caps":
        return cls(tuple(structures))

    @property
    def is_empty(self) -> bool:
        return not self.structures

    @property
    def is_fixed(self) -> bool:
        return len(self.structures) == 1 and self.structures[0].is_fixed

    def intersect(self, other: "Caps") -> "Caps":
        out = []
        for a in self.structures:
            for b in other.structures:
                s = a.intersect(b)
                if s is not None and s not in out:
                    out.append(s)
        return Caps(tuple(out))

    def can_intersect(self, other: "Caps") -> bool:
        return not self.intersect(other).is_empty

    def fixate(self) -> "Caps":
        if self.is_empty:
            raise ValueError("cannot fixate empty caps")
        return Caps((self.structures[0].fixate(),))

    @property
    def first(self) -> Structure:
        if self.is_empty:
            raise ValueError("empty caps")
        return self.structures[0]

    def __str__(self):
        if self.is_empty:
            return "EMPTY"
        return ";".join(str(s) for s in self.structures)


# ---------------------------------------------------------------------------
# tensors <-> caps bridging (reference gst_tensor_caps_from_config /
# gst_tensors_config_from_caps, nnstreamer_plugin_api_impl.c)
# ---------------------------------------------------------------------------

def caps_from_tensors_info(info: TensorsInfo, framerate=None) -> Caps:
    fields = info.to_fields()
    if framerate is not None:
        fields["framerate"] = framerate
    return Caps.new(TENSORS_MIME, **fields)


def tensors_info_from_caps(caps: Caps) -> TensorsInfo:
    s = caps.first
    if s.media_type != TENSORS_MIME:
        raise ValueError(f"not a tensor caps: {s.media_type}")
    return TensorsInfo.from_fields(s.as_dict())


def caps_tensor_format(caps: Caps):
    """The TensorFormat a tensor caps declares, or None for non-tensor /
    format-unconstrained caps (used by negotiation-adjacent consumers
    like the static linter's flexible-stream checks)."""
    if caps.is_empty:
        return None
    s = caps.first
    if s.media_type != TENSORS_MIME:
        return None
    fmt = s.get("format")
    if fmt is None or not isinstance(fmt, str):
        return None
    try:
        return TensorFormat(fmt)
    except ValueError:
        return None


def tensors_any_caps() -> Caps:
    """Template caps accepting any tensor stream."""
    return Caps.any_of(
        Structure.new(TENSORS_MIME, format=ValueList(tuple(f.value for f in TensorFormat)))
    )


# IDL byte-stream MIMEs (reference: other/protobuf-tensor caps of
# ext/nnstreamer/extra/nnstreamer_protobuf.h, flatbuf analog; other/flexbuf
# is the tensordec-flexbuf.cc output MIME the corpus pipes through
# capsfilters: ``tensor_decoder mode=flexbuf ! other/flexbuf ! ...``)
PROTOBUF_MIME = "other/protobuf-tensor"
FLATBUF_MIME = "other/flatbuf-tensor"
FLEXBUF_MIME = "other/flexbuf"

ALL_MIMES = (TENSORS_MIME, VIDEO_MIME, AUDIO_MIME, TEXT_MIME, OCTET_MIME,
             PROTOBUF_MIME, FLATBUF_MIME, FLEXBUF_MIME,
             # compressed-image streams (filesrc ! image/png,... ! pngdec —
             # the reference test idiom; imagedec sniffs the actual codec)
             "image/png", "image/jpeg", "image/bmp",
             "image/x-portable-graymap", "image/x-portable-pixmap",
             "image/x-portable-anymap")


def any_media_caps() -> Caps:
    """Template caps accepting every media type (queue/tee/sink templates)."""
    return Caps(tuple(Structure.new(m) for m in ALL_MIMES))


# ---------------------------------------------------------------------------
# caps-string parsing for launch lines: "other/tensors,format=static,
# dimensions=3:224:224:1,types=uint8" — the reference's capsfilter syntax.
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"^-?\d+$")
_FLOAT_RE = re.compile(r"^-?\d*\.\d+$")
_RANGE_RE = re.compile(r"^\[\s*(-?\d+)\s*,\s*(-?\d+)\s*\]$")
_LIST_RE = re.compile(r"^\{(.*)\}$")


def _parse_field_value(text: str):
    text = text.strip()
    # GStreamer typed values: `(string)RGB`, `(int)640`, `(fraction)30/1`
    # — strip the annotation, the value parser below infers the type
    if text.startswith("(") and ")" in text:
        text = text[text.index(")") + 1:].strip()
    m = _RANGE_RE.match(text)
    if m:
        return IntRange(int(m.group(1)), int(m.group(2)))
    m = _LIST_RE.match(text)
    if m:
        return ValueList(tuple(_parse_field_value(p) for p in m.group(1).split(",")))
    if _NUM_RE.match(text):
        return int(text)
    if _FLOAT_RE.match(text):
        return float(text)
    if "/" in text and all(_NUM_RE.match(p) for p in text.split("/", 1)):
        num, den = text.split("/", 1)
        return (int(num), int(den))  # framerate fraction
    return text


# GStreamer MIME spellings → our canonical media types, so the
# reference's launch lines (`video/x-raw`, `audio/x-raw`,
# `application/octet-stream`, `text/x-raw`, `other/tensor` singular)
# parse unchanged (reference caps strings appear throughout its
# tests/*/runTest.sh)
_MEDIA_ALIASES = {
    "video/x-raw": VIDEO_MIME,
    "audio/x-raw": AUDIO_MIME,
    "text/x-raw": TEXT_MIME,
    "application/octet-stream": OCTET_MIME,
    "other/tensor": TENSORS_MIME,
}

# field spellings that differ between GStreamer caps and ours
_FIELD_ALIASES = {"dimension": "dimensions", "type": "types"}


def parse_caps_string(text: str) -> Caps:
    structures = []
    for struct_text in text.split(";"):
        parts = _split_fields(struct_text.strip())
        media = _MEDIA_ALIASES.get(parts[0], parts[0])
        fields = {}
        for p in parts[1:]:
            if not p:
                continue
            k, _, v = p.partition("=")
            k = k.strip()
            fields[_FIELD_ALIASES.get(k, k)] = _parse_field_value(v)
        structures.append(Structure.new(media, **fields))
    return Caps(tuple(structures))


def _split_fields(text: str):
    """Split on commas not inside {} or [] (list/range values contain commas)."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


def looks_like_caps(text: str) -> bool:
    head = text.split(",", 1)[0].strip()
    return "/" in head and "=" not in head
