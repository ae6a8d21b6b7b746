"""Byte-stream converters: the serialization decoders' inverses (L4).

Reference analogs: ``tensor_converter_flexbuf.cc`` / ``-protobuf.cc`` /
``-flatbuf.cc`` — deserialize ``other/flexbuf`` / ``other/protobuf-tensor``
/ ``other/flatbuf-tensor`` streams back to ``other/tensors``. flexbuf uses
the framework's own portable framing (core/serialize.py); protobuf and
flatbuf parse the reference's actual wire formats (core/wire_protobuf.py,
core/wire_flatbuf.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import Buffer, Caps, TensorFormat, TensorsInfo
from ..core.serialize import unpack_tensors
from .base import Converter, register_converter


def _blob(buf: Buffer) -> bytes:
    return np.ascontiguousarray(np.asarray(buf.as_numpy().tensors[0])).tobytes()


@register_converter
class BytesConverter(Converter):
    NAME = "flexbuf"

    def get_out_info(self, in_caps: Caps) -> TensorsInfo:
        return TensorsInfo((), TensorFormat.FLEXIBLE)  # shapes ride per frame

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        out = unpack_tensors(_blob(buf))
        out.pts = buf.pts if out.pts is None else out.pts
        return out


class _WireConverter(Converter):
    """Shared shape for the two reference-wire converters."""

    def get_out_info(self, in_caps: Caps) -> TensorsInfo:
        return TensorsInfo((), TensorFormat.FLEXIBLE)

    def _decode(self, blob: bytes):
        raise NotImplementedError

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        arrays, names, fmt, rate = self._decode(_blob(buf))
        if fmt is TensorFormat.SPARSE:
            # sparse wire payloads carry index/value encodings that must not
            # be silently reshaped as dense data
            raise NotImplementedError(
                f"{self.NAME} converter: sparse wire frames not supported; "
                "route through tensor_sparse_dec on the producing side")
        out = Buffer(list(arrays))
        out.pts = buf.pts
        if any(names):
            out.meta["tensor_names"] = names
        if rate != (0, 0):
            out.meta["framerate"] = rate
        return out


@register_converter
class ProtobufConverter(_WireConverter):
    NAME = "protobuf"

    def _decode(self, blob: bytes):
        from ..core.wire_protobuf import decode_tensors

        return decode_tensors(blob)


@register_converter
class FlatbufConverter(_WireConverter):
    NAME = "flatbuf"

    def _decode(self, blob: bytes):
        from ..core.wire_flatbuf import decode_tensors

        return decode_tensors(blob)
