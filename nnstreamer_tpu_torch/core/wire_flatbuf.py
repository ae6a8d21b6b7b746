"""Hand-rolled flatbuffers codec for the nnstreamer ``Tensors`` schema.

Wire-compatible with the reference's flatc-generated code
(``ext/nnstreamer/include/nnstreamer.fbs``: table ``Tensors{num_tensor,
fr:frame_rate struct, tensor:[Tensor], format}``, table ``Tensor{name,
type, dimension:[uint32], data:[ubyte]}``) without needing flatc or the
flatbuffers runtime: the binary layout (root uoffset, vtables, tables,
vectors, strings — all little-endian) is produced and parsed directly.

Builder strategy: children are written bottom-up (prepend order =
reverse file order) and each table's vtable is placed immediately before
it in the file, so the table's soffset is simply the vtable length —
no back-patching needed. All scalars here are 4-byte, so 4-alignment
throughout satisfies the format's alignment rules.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .tensors import TensorFormat
from .wire_protobuf import WIRE_TYPES, dims_of, shape_of, wire_type_of
from .tensors import DataType

_FMT_VAL = {TensorFormat.STATIC: 0, TensorFormat.FLEXIBLE: 1, TensorFormat.SPARSE: 2}
_VAL_FMT = {v: k for k, v in _FMT_VAL.items()}


class _Builder:
    """Minimal flatbuffers builder: prepend-ordered chunks; an object's
    'offset' is its distance from the file end to its first byte."""

    def __init__(self):
        self._chunks: List[bytes] = []
        self._written = 0

    def _prepend(self, b: bytes) -> None:
        self._chunks.append(b)
        self._written += len(b)

    def _pad_to4(self, upcoming: int) -> None:
        """Trailing padding so the next ``upcoming`` bytes end 4-aligned."""
        pad = (-(self._written + upcoming)) % 4
        if pad:
            self._prepend(b"\0" * pad)

    def byte_vector(self, data: bytes) -> int:
        self._pad_to4(len(data) + 4)
        self._prepend(data)
        self._prepend(struct.pack("<I", len(data)))
        return self._written

    def string(self, s: str) -> int:
        raw = s.encode() + b"\0"  # NUL terminator per spec
        self._pad_to4(len(raw) + 4)
        self._prepend(raw)
        self._prepend(struct.pack("<I", len(raw) - 1))
        return self._written

    def u32_vector(self, vals: List[int]) -> int:
        self._pad_to4(0)
        self._prepend(struct.pack(f"<I{len(vals)}I", len(vals), *vals))
        return self._written

    def offset_vector(self, offsets: List[int]) -> int:
        """Vector of uoffsets to already-written tables."""
        self._pad_to4(0)
        body = bytearray(struct.pack("<I", len(offsets)))
        # element j sits at distance (written + 4*(len-j)) from file end
        # once the whole [len][elems] block is prepended
        total = self._written + 4 * (len(offsets) + 1)
        for j, off in enumerate(offsets):
            elem_pos = total - 4 * (1 + j)  # distance from end to elem start
            body += struct.pack("<I", elem_pos - off)
        self._prepend(bytes(body))
        return self._written

    def table(self, fields: List[Optional[Tuple[str, object]]]) -> int:
        """Write a table. ``fields[i]`` is None (absent) or one of
        ('i32', int) inline scalar, ('ref', offset) uoffset to a child,
        ('struct', bytes) inline struct."""
        # lay out the table body: soffset + fields in declaration order
        slots: List[Tuple[str, object, int]] = []  # (kind, val, table_local_off)
        local = 4
        vt_offsets = []
        for f in fields:
            if f is None:
                vt_offsets.append(0)
                continue
            kind, val = f
            size = len(val) if kind == "struct" else 4
            vt_offsets.append(local)
            slots.append((kind, val, local))
            local += size
        table_len = local
        vt_len = 4 + 2 * len(fields)
        self._pad_to4(table_len + vt_len)
        # table start distance once body+vtable are prepended:
        table_off = self._written + table_len
        body = bytearray(struct.pack("<i", vt_len))  # soffset: vtable is
        # written immediately before the table in the file
        for kind, val, loc in slots:
            if kind == "i32":
                body += struct.pack("<i", int(val))
            elif kind == "struct":
                body += bytes(val)
            else:  # uoffset: relative to the field's own position
                field_pos = table_off - loc
                body += struct.pack("<I", field_pos - int(val))
        assert len(body) == table_len
        self._prepend(bytes(body))
        vt = struct.pack(f"<HH{len(fields)}H", vt_len, table_len, *vt_offsets)
        self._prepend(vt)
        return table_off

    def finish(self, root: int) -> bytes:
        self._pad_to4(4)
        total = self._written + 4
        self._prepend(struct.pack("<I", total - root))
        return b"".join(reversed(self._chunks))


def encode_tensors(arrays: List[np.ndarray], names: Optional[List[str]] = None,
                   fmt: TensorFormat = TensorFormat.STATIC,
                   rate: Tuple[int, int] = (0, 0)) -> bytes:
    b = _Builder()
    tensor_offs = []
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(a)
        data_off = b.byte_vector(a.tobytes())
        dims_off = b.u32_vector(dims_of(a.shape))
        name = names[i] if names and i < len(names) else ""
        name_off = b.string(name)
        tensor_offs.append(b.table([
            ("ref", name_off),
            ("i32", wire_type_of(DataType.from_any(a.dtype))),
            ("ref", dims_off),
            ("ref", data_off),
        ]))
    vec_off = b.offset_vector(tensor_offs)
    fr = struct.pack("<ii", rate[0], rate[1])
    root = b.table([
        ("i32", len(arrays)),
        ("struct", fr),
        ("ref", vec_off),
        ("i32", _FMT_VAL[fmt]),
    ])
    return b.finish(root)


class _Reader:
    def __init__(self, blob: bytes):
        self.b = blob

    def u16(self, pos: int) -> int:
        return struct.unpack_from("<H", self.b, pos)[0]

    def i32(self, pos: int) -> int:
        return struct.unpack_from("<i", self.b, pos)[0]

    def u32(self, pos: int) -> int:
        return struct.unpack_from("<I", self.b, pos)[0]

    def field(self, table: int, idx: int) -> int:
        """Table-local offset of field ``idx``; 0 if absent."""
        vtable = table - self.i32(table)
        vt_len = self.u16(vtable)
        slot = 4 + 2 * idx
        if slot >= vt_len:
            return 0
        return self.u16(vtable + slot)

    def scalar(self, table: int, idx: int, default: int = 0) -> int:
        off = self.field(table, idx)
        return self.i32(table + off) if off else default

    def ref(self, table: int, idx: int) -> Optional[int]:
        off = self.field(table, idx)
        if not off:
            return None
        pos = table + off
        return pos + self.u32(pos)

    def string(self, table: int, idx: int) -> str:
        pos = self.ref(table, idx)
        if pos is None:
            return ""
        ln = self.u32(pos)
        return self.b[pos + 4:pos + 4 + ln].decode()

    def vector(self, pos: int, elem: int) -> Tuple[int, int]:
        """(element count, first-element position)."""
        return self.u32(pos), pos + 4


def decode_tensors(blob: bytes
                   ) -> Tuple[List[np.ndarray], List[str], TensorFormat, Tuple[int, int]]:
    r = _Reader(blob)
    root = r.u32(0)
    rate = (0, 0)
    fr_off = r.field(root, 1)
    if fr_off:
        rate = (r.i32(root + fr_off), r.i32(root + fr_off + 4))
    fmt = _VAL_FMT.get(r.scalar(root, 3, 0), TensorFormat.STATIC)
    arrays: List[np.ndarray] = []
    names: List[str] = []
    vec = r.ref(root, 2)
    if vec is not None:
        n, pos = r.vector(vec, 4)
        for j in range(n):
            elem_pos = pos + 4 * j
            table = elem_pos + r.u32(elem_pos)
            names.append(r.string(table, 0))
            wt = r.scalar(table, 1, len(WIRE_TYPES))
            dvec = r.ref(table, 2)
            dims = []
            if dvec is not None:
                dn, dpos = r.vector(dvec, 4)
                dims = [r.u32(dpos + 4 * k) for k in range(dn)]
            data = b""
            bvec = r.ref(table, 3)
            if bvec is not None:
                bn, bpos = r.vector(bvec, 1)
                data = r.b[bpos:bpos + bn]
            dt = WIRE_TYPES[wt]
            arrays.append(np.frombuffer(data, dt.np_dtype).reshape(shape_of(dims)))
    return arrays, names, fmt, rate
