"""Hand-rolled proto3 wire codec for the nnstreamer ``Tensors`` message.

Wire-compatible with the reference's generated protobuf code
(``ext/nnstreamer/include/nnstreamer.proto`` → serialize loop in
``ext/nnstreamer/extra/nnstreamer_protobuf.cc:60-130``): message
``Tensors{num_tensor=1, fr{rate_n=1, rate_d=2}=2, repeated Tensor=3,
format=4}``, ``Tensor{name=1, type=2, repeated uint32 dimension=3 (packed,
all 16 rank slots, innermost-first), data=4}``. Implemented directly on
the proto3 wire format (varint tags, length-delimited fields, canonical
field order, zero-default omission) so no generated code or schema file
is needed at runtime — byte-compatible with C++ ``SerializeToArray``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .tensors import DataType, TensorFormat

RANK_LIMIT = 16

# nnstreamer tensor_type enum order — shared by the .proto and .fbs enums
WIRE_TYPES: List[DataType] = [
    DataType.INT32, DataType.UINT32, DataType.INT16, DataType.UINT16,
    DataType.INT8, DataType.UINT8, DataType.FLOAT64, DataType.FLOAT32,
    DataType.INT64, DataType.UINT64,
]
_TYPE_TO_WIRE = {t: i for i, t in enumerate(WIRE_TYPES)}


def wire_type_of(dt: DataType) -> int:
    if dt not in _TYPE_TO_WIRE:
        raise ValueError(f"dtype {dt.value} not representable on the nnstreamer wire")
    return _TYPE_TO_WIRE[dt]


def dims_of(shape: Tuple[int, ...]) -> List[int]:
    """numpy shape → 16 innermost-first rank slots (0-padded)."""
    dims = [int(d) for d in reversed(shape)]
    return dims + [0] * (RANK_LIMIT - len(dims))


def shape_of(dims: List[int]) -> Tuple[int, ...]:
    used = []
    for d in dims:
        if d <= 0:
            break
        used.append(d)
    return tuple(reversed(used))


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # negative int32s ride as 10-byte two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_tensors(arrays: List[np.ndarray], names: Optional[List[str]] = None,
                   fmt: TensorFormat = TensorFormat.STATIC,
                   rate: Tuple[int, int] = (0, 0)) -> bytes:
    """Serialize arrays as one ``Tensors`` frame (canonical proto3 bytes)."""
    out = bytearray()
    out += _tag(1, 0) + _varint(len(arrays))  # num_tensor (>=1 in practice)
    fr = bytearray()  # fr submessage: present (reference always sets it)
    if rate[0]:
        fr += _tag(1, 0) + _varint(rate[0])
    if rate[1]:
        fr += _tag(2, 0) + _varint(rate[1])
    out += _len_field(2, bytes(fr))
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(a)
        t = bytearray()
        name = names[i] if names and i < len(names) else ""
        if name:
            t += _len_field(1, name.encode())
        wt = wire_type_of(DataType.from_any(a.dtype))
        if wt:
            t += _tag(2, 0) + _varint(wt)
        packed = b"".join(_varint(d) for d in dims_of(a.shape))
        t += _len_field(3, packed)
        t += _len_field(4, a.tobytes())
        out += _len_field(3, bytes(t))
    fmt_val = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1,
               TensorFormat.SPARSE: 2}[fmt]
    if fmt_val:
        out += _tag(4, 0) + _varint(fmt_val)
    return bytes(out)


def _read_varint(blob: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = blob[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _read_fields(blob: bytes):
    """Yield (field, wire, value) — value is int for varint, bytes for
    length-delimited; unknown wire types are skipped per proto rules."""
    pos = 0
    while pos < len(blob):
        key, pos = _read_varint(blob, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(blob, pos)
        elif wire == 2:
            ln, pos = _read_varint(blob, pos)
            val = blob[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = blob[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = blob[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"protobuf wire type {wire} unsupported")
        yield field, wire, val


def decode_tensors(blob: bytes
                   ) -> Tuple[List[np.ndarray], List[str], TensorFormat, Tuple[int, int]]:
    """Parse one ``Tensors`` frame → (arrays, names, format, (rate_n, rate_d))."""
    arrays: List[np.ndarray] = []
    names: List[str] = []
    fmt = TensorFormat.STATIC
    rate = [0, 0]
    for field, wire, val in _read_fields(blob):
        if field == 2 and wire == 2:  # fr
            for f2, w2, v2 in _read_fields(val):
                if f2 in (1, 2) and w2 == 0:
                    rate[f2 - 1] = v2
        elif field == 3 and wire == 2:  # Tensor
            name, wt, dims, data = "", 0, [], b""
            for f2, w2, v2 in _read_fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode()
                elif f2 == 2 and w2 == 0:
                    wt = v2
                elif f2 == 3 and w2 == 2:  # packed dimension
                    p = 0
                    while p < len(v2):
                        d, p = _read_varint(v2, p)
                        dims.append(d)
                elif f2 == 3 and w2 == 0:  # unpacked fallback
                    dims.append(v2)
                elif f2 == 4 and w2 == 2:
                    data = v2
            dt = WIRE_TYPES[wt]
            shape = shape_of(dims)
            arrays.append(np.frombuffer(data, dt.np_dtype).reshape(shape))
            names.append(name)
        elif field == 4 and wire == 0:
            fmt = {0: TensorFormat.STATIC, 1: TensorFormat.FLEXIBLE,
                   2: TensorFormat.SPARSE}[val]
    return arrays, names, fmt, (rate[0], rate[1])
