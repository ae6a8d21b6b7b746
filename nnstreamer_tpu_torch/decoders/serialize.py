"""Serialization decoders: tensors → IDL byte streams (L4).

Reference analogs: ``tensordec-flexbuf.cc`` (portable framing →
``other/flexbuf``), ``tensordec-protobuf.cc`` (``other/protobuf-tensor``,
nnstreamer.proto wire), ``tensordec-flatbuf.cc`` (``other/flatbuf-tensor``,
nnstreamer.fbs wire). flexbuf uses the framework's own portable framing
(core/serialize.py); protobuf/flatbuf emit the reference's actual wire
formats (core/wire_protobuf.py, core/wire_flatbuf.py) for cross-ecosystem
parity. They encode on the host: a batch of device tensors is pulled once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import Buffer, Caps, TensorFormat, TensorsInfo
from ..core.caps import FLATBUF_MIME, FLEXBUF_MIME, PROTOBUF_MIME
from ..core.serialize import pack_tensors
from .base import Decoder, register_decoder


@register_decoder
class FlexBuf(Decoder):
    MODE = "flexbuf"

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        # reference MIME (tensordec-flexbuf.cc): the corpus constrains the
        # stream with ``! other/flexbuf !`` capsfilters downstream
        return Caps.new(FLEXBUF_MIME)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        return Buffer([np.frombuffer(pack_tensors(buf), np.uint8)])


class _WireDecoder(Decoder):
    """Shared shape for the two reference-IDL encoders."""

    MIME = ""

    def _encode(self, arrays, names, fmt) -> bytes:
        raise NotImplementedError

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        from ..core.wire_protobuf import _TYPE_TO_WIRE

        if in_info is not None and in_info.specs:
            # dtypes unrepresentable on the nnstreamer wire (float16,
            # bfloat16, bool) must fail at negotiation, not first buffer
            if any(s.dtype not in _TYPE_TO_WIRE for s in in_info.specs):
                return None
        return Caps.new(self.MIME)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        arrays = [np.asarray(t) for t in buf.as_numpy().tensors]
        names = ([s.name or "" for s in in_info.specs]
                 if in_info is not None and in_info.specs else None)
        fmt = in_info.format if in_info is not None else TensorFormat.STATIC
        blob = self._encode(arrays, names, fmt)
        return Buffer([np.frombuffer(blob, np.uint8)])


@register_decoder
class ProtobufDecoder(_WireDecoder):
    MODE = "protobuf"
    MIME = PROTOBUF_MIME

    def _encode(self, arrays, names, fmt) -> bytes:
        from ..core.wire_protobuf import encode_tensors

        return encode_tensors(arrays, names, fmt=fmt)


@register_decoder
class FlatbufDecoder(_WireDecoder):
    MODE = "flatbuf"
    MIME = FLATBUF_MIME

    def _encode(self, arrays, names, fmt) -> bytes:
        from ..core.wire_flatbuf import encode_tensors

        return encode_tensors(arrays, names, fmt=fmt)
