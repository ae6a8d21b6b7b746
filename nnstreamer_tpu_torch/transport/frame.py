"""Binary tensor-frame wire codec — the NNSB frame (L5).

The counterpart of nnstreamer_tpu's ``transport/frame.py``; frames are
byte-equal to its for the same tensors and meta. The NNST codec
(core/serialize) carries a JSON meta sidecar parsed per frame; this
module is the negotiated replacement: a fixed-layout frame whose decode
is a handful of ``struct.unpack_from`` calls and whose encode emits
scatter-gather ``memoryview`` parts (``protocol.send_msg`` hands them to
one ``sendmsg`` — no concatenation copy, NNL405's contract).

Frame layout (version 1, little-endian throughout)::

  header   "NNSB" | u16 version | u16 flags | u32 n_tensors |
           u32 meta_len | f64 pts (nan = None)          (24 bytes)
  table    n_tensors fixed entries:                     (80 bytes each)
           u8 dtype_code | u8 rank | u16 tflags | u32 extra |
           u64 nbytes | u64 dims[8]
  payload  raw tensor bytes, concatenated in table order
  meta     compact tagged binary sidecar                (meta_len bytes)

Per-tensor ``tflags`` bit0 = sparse: dtype/dims describe the DENSE
tensor, ``extra`` carries nnz and the payload is ``int32 idx[nnz] |
value[nnz]`` (the tensor_sparse_enc COO layout NNST v2 also ships).
The meta sidecar sits AFTER the payload so a decoder computes every
tensor offset from the fixed-size table alone.

Negotiation rides the CAPABILITY handshake as an extra caps structure
(:data:`WIRE_MIME`) — see :func:`offer_caps`/:func:`split_wire_caps`.
Old peers ignore the structure (caps intersection is any-pair) and keep
speaking NNST+JSON; both sides sniff the frame magic on receive, so a
mixed fleet never misparses either format.

Tensors in the port's buffers are numpy arrays, CPU torch tensors or CUDA
torch tensors. ``encode_frame`` pulls each card tensor to the host once
(one device→host copy, counted in :mod:`.stats` as ``d2h``); bfloat16,
which numpy lacks, travels as its uint16 bit patterns under the bfloat16
dtype code, and decodes to a CPU ``torch.bfloat16`` tensor. Every other
dtype decodes to a numpy array.
"""
from __future__ import annotations

import math
import struct
import sys as _sys
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import Buffer
from ..core.serialize import (MAX_META_BYTES, MAX_PAYLOAD_BYTES,
                              MAX_TENSORS, SPARSE_META_KEY,
                              _META_ARRAY_MAX)
from ..core.tensors import DataType, TensorSpec

MAGIC = b"NNSB"
VERSION = 1
MAX_RANK = 8

_HEADER = struct.Struct("<4sHHIId")   # magic, version, flags, n, meta_len, pts
_TENTRY = struct.Struct("<BBHIQ8Q")   # dtype, rank, tflags, extra, nbytes, dims
_TFLAG_SPARSE = 0x01

# wire ABI: codes are the DataType definition order, append-only
_DTYPE_CODES = {dt: i + 1 for i, dt in enumerate(DataType)}
_CODE_DTYPES = {c: dt for dt, c in _DTYPE_CODES.items()}
# per-frame hot path: DataType.from_any walks numpy dtype names and the
# np_dtype/itemsize properties re-build np.dtype each call — dominate
# the codec at small frames. One table each, built once.
# bfloat16 (no numpy dtype) maps to None: its payload is read as uint16
_NP_TO_CODE = {dt.np_dtype: code for dt, code in _DTYPE_CODES.items()
               if dt is not DataType.BFLOAT16}
_CODE_NP = {c: (dt, None if dt is DataType.BFLOAT16 else dt.np_dtype,
                dt.itemsize) for c, dt in _CODE_DTYPES.items()}
_BF16_CODE = _DTYPE_CODES[DataType.BFLOAT16]

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_warned_meta_keys = set()


class FrameError(ValueError):
    """Malformed, truncated, or unencodable NNSB frame. Decode raises it
    for torn headers / tensor tables / payloads (a mid-frame disconnect
    must surface as a typed error, never parse as a shorter frame);
    encode raises it for shapes the fixed table cannot carry (rank >
    :data:`MAX_RANK`) so callers can fall back to the NNST codec."""


def is_binary_frame(blob) -> bool:
    """Magic sniff: does this DATA payload start an NNSB frame?"""
    view = memoryview(blob)
    return view.nbytes >= 4 and bytes(view[:4]) == MAGIC


# ---------------------------------------------------------------------------
# compact meta sidecar — a tagged binary codec replacing per-frame JSON
# ---------------------------------------------------------------------------
# tags: N none | T/F bool | i i64 | I big-int decimal | f f64 | s str |
#       b bytes | l list | d dict — covers everything the JSON sidecar
#       carried (trace/fabric/serving dicts, client ids, caps strings)

def _enc_value(out: bytearray, v) -> None:
    if v is None:
        out += b"N"
    elif isinstance(v, bool):
        out += b"T" if v else b"F"
    elif isinstance(v, (int, np.integer)):
        v = int(v)
        if -(1 << 63) <= v < (1 << 63):
            out += b"i"
            out += _I64.pack(v)
        else:
            s = str(v).encode()
            out += b"I"
            out += _U32.pack(len(s))
            out += s
    elif isinstance(v, (float, np.floating)):
        out += b"f"
        out += _F64.pack(float(v))
    elif isinstance(v, str):
        s = v.encode()
        out += b"s"
        out += _U32.pack(len(s))
        out += s
    elif isinstance(v, (bytes, bytearray, memoryview)):
        mv = memoryview(v)
        out += b"b"
        out += _U32.pack(mv.nbytes)
        out += mv
    elif isinstance(v, (list, tuple)):
        out += b"l"
        out += _U32.pack(len(v))
        for item in v:
            _enc_value(out, item)
    elif isinstance(v, dict):
        out += b"d"
        out += _U32.pack(len(v))
        # canonical order for nested dicts too (see _pack_meta)
        for k, item in sorted(v.items(), key=lambda kv: str(kv[0])):
            ks = str(k).encode()
            out += _U32.pack(len(ks))
            out += ks
            _enc_value(out, item)
    elif isinstance(v, (set, frozenset)):
        _enc_value(out, sorted(v))
    elif isinstance(v, np.generic):
        _enc_value(out, v.item())
    elif isinstance(v, np.ndarray):
        if v.size > _META_ARRAY_MAX:
            # nested inside a list/dict value the top-level drop can't
            # see: refuse loudly rather than inflate the frame (the NNST
            # codec's rule, core/serialize._meta_default)
            raise TypeError(
                f"ndarray of {v.size} elements nested in meta "
                f"(>{_META_ARRAY_MAX}); ship large arrays as tensors")
        _enc_value(out, v.tolist())
    else:
        raise TypeError(f"{type(v).__name__} is not wire-serializable")


def _pack_meta(meta: dict) -> bytearray:
    """Encode buffer meta; numpy coercions, the oversized-ndarray drop
    (warn once per key) and the loud non-serializable failure mirror the
    NNST codec so the two wire formats accept the same frames."""
    from ..utils.log import logger

    items = []
    # canonical encoding: two processes building the same meta dict in
    # different insertion order must emit identical bytes (hash/insertion
    # order is not part of the wire contract)
    for k, v in sorted(meta.items(), key=lambda kv: str(kv[0])):
        if k == SPARSE_META_KEY:
            continue  # carried in the per-tensor table entries
        if isinstance(v, np.ndarray) and v.size > _META_ARRAY_MAX:
            if k not in _warned_meta_keys:
                _warned_meta_keys.add(k)
                logger.warning(
                    "meta['%s'] (%d-element ndarray) dropped from the wire: "
                    "arrays >%d elements must travel as tensors, not meta",
                    k, v.size, _META_ARRAY_MAX)
            continue
        items.append((str(k), v))
    out = bytearray(_U32.pack(len(items)))
    for k, v in items:
        ks = k.encode()
        out += _U32.pack(len(ks))
        out += ks
        try:
            _enc_value(out, v)
        except TypeError as e:
            raise TypeError(
                f"buffer meta key '{k}' is not wire-serializable: {e}; "
                "convert to JSON-able values before crossing a process "
                "boundary")
    return out


class _Reader:
    """Bounds-checked cursor over one frame view: every short read is a
    typed :class:`FrameError` naming the torn region."""

    __slots__ = ("view", "off")

    def __init__(self, view: memoryview, off: int = 0):
        self.view = view
        self.off = off

    def take(self, n: int, what: str) -> memoryview:
        end = self.off + n
        if end > self.view.nbytes:
            raise FrameError(
                f"torn {what}: frame ends at byte {self.view.nbytes}, "
                f"needed {end}")
        out = self.view[self.off:end]
        self.off = end
        return out

    def unpack(self, st: struct.Struct, what: str) -> tuple:
        if self.off + st.size > self.view.nbytes:
            raise FrameError(
                f"torn {what}: frame ends at byte {self.view.nbytes}, "
                f"needed {self.off + st.size}")
        vals = st.unpack_from(self.view, self.off)
        self.off += st.size
        return vals


def _dec_value(r: _Reader):
    tag = bytes(r.take(1, "meta sidecar"))
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return r.unpack(_I64, "meta sidecar")[0]
    if tag == b"f":
        return r.unpack(_F64, "meta sidecar")[0]
    if tag in (b"s", b"b", b"I"):
        (n,) = r.unpack(_U32, "meta sidecar")
        raw = r.take(n, "meta sidecar")
        if tag == b"b":
            return bytes(memoryview(raw))  # small meta value, owning copy
        text = str(raw, "utf-8")
        return int(text) if tag == b"I" else text
    if tag == b"l":
        (n,) = r.unpack(_U32, "meta sidecar")
        if n > r.view.nbytes - r.off:  # every item is >= 1 tag byte
            raise FrameError(
                f"torn meta sidecar: list claims {n} items, "
                f"{r.view.nbytes - r.off} bytes remain")
        return [_dec_value(r) for _ in range(n)]
    if tag == b"d":
        (n,) = r.unpack(_U32, "meta sidecar")
        if n > r.view.nbytes - r.off:  # every entry is >= 5 bytes
            raise FrameError(
                f"torn meta sidecar: dict claims {n} entries, "
                f"{r.view.nbytes - r.off} bytes remain")
        out = {}
        for _ in range(n):
            (kn,) = r.unpack(_U32, "meta sidecar")
            key = str(r.take(kn, "meta sidecar"), "utf-8")
            out[key] = _dec_value(r)
        return out
    raise FrameError(f"unknown meta tag {tag!r}")


def _unpack_meta(view: memoryview) -> dict:
    r = _Reader(view)
    (n,) = r.unpack(_U32, "meta sidecar")
    if n > view.nbytes:  # every entry is >= 5 bytes (keylen + tag)
        raise FrameError(
            f"torn meta sidecar: {n} entries claimed in "
            f"{view.nbytes} bytes")
    out = {}
    for _ in range(n):
        (kn,) = r.unpack(_U32, "meta sidecar")
        key = str(r.take(kn, "meta sidecar"), "utf-8")
        out[key] = _dec_value(r)
    return out


# ---------------------------------------------------------------------------
# frame encode / decode
# ---------------------------------------------------------------------------

def encode_frame(buf: Buffer, extra_meta: Optional[dict] = None
                 ) -> List[memoryview]:
    """Serialize one frame into scatter-gather parts.

    Returns ``[header+table, tensor bytes..., meta]`` memoryviews:
    ``protocol.send_msg`` writes them with one ``sendmsg`` and the shm
    ring copies them straight into a slot — the tensor payloads are
    BORROWED views of the buffer's arrays, copied zero times here
    (``pack_tensors`` pays one gather copy per frame even on the send
    path). Use :func:`encode_frame_bytes` when an owning contiguous
    frame is required.
    """
    arrays, codes = _host_arrays(buf.tensors)
    meta = dict(buf.meta)
    if extra_meta:
        meta.update(extra_meta)
    specs = meta.get(SPARSE_META_KEY)
    meta_blob = _pack_meta(meta)
    head = bytearray()
    parts: List[memoryview] = []
    if specs is None:
        n_wire = len(arrays)
        for a, code in zip(arrays, codes):
            if a.ndim > MAX_RANK:
                raise FrameError(
                    f"rank-{a.ndim} tensor exceeds the fixed table's "
                    f"{MAX_RANK} dims; falling back to the NNST codec")
            dims = tuple(a.shape) + (0,) * (MAX_RANK - a.ndim)
            head += _TENTRY.pack(code, a.ndim, 0, 0, a.nbytes, *dims)
            parts.append(a.reshape(-1).view(np.uint8).data)
    else:
        if len(arrays) != 2 * len(specs):
            raise ValueError(
                f"sparse frame carries {len(arrays)} arrays for "
                f"{len(specs)} specs (want idx/value pairs)")
        n_wire = len(specs)
        for i, spec in enumerate(specs):
            idx = np.ascontiguousarray(arrays[2 * i], np.int32)
            vals = arrays[2 * i + 1]
            dtype = DataType.from_any(spec.dtype)
            if _CODE_DTYPES[codes[2 * i + 1]] is not dtype:
                raise ValueError(
                    f"sparse tensor {i}: values dtype "
                    f"{_CODE_DTYPES[codes[2 * i + 1]].value} != "
                    f"dense spec dtype {dtype.value}")
            if idx.size != vals.size:
                raise ValueError(
                    f"sparse tensor {i}: {idx.size} indices but "
                    f"{vals.size} values")
            shape = tuple(int(d) for d in spec.shape)
            if len(shape) > MAX_RANK:
                raise FrameError(
                    f"rank-{len(shape)} sparse spec exceeds the fixed "
                    f"table's {MAX_RANK} dims")
            dims = shape + (0,) * (MAX_RANK - len(shape))
            head += _TENTRY.pack(_DTYPE_CODES[dtype], len(shape),
                                 _TFLAG_SPARSE, idx.size,
                                 idx.nbytes + vals.nbytes, *dims)
            parts.append(idx.view(np.uint8).data)
            parts.append(vals.reshape(-1).view(np.uint8).data)
    header = _HEADER.pack(MAGIC, VERSION, 0, n_wire, len(meta_blob),
                          math.nan if buf.pts is None else buf.pts)
    out = [memoryview(header + head)] + parts + [memoryview(meta_blob)]
    _note_wire_bytes("wire:encode", frame_nbytes(out))
    return out


def _host_arrays(tensors) -> Tuple[List[np.ndarray], List[int]]:
    """Each tensor as a C-contiguous host ndarray with its dtype code. A
    card tensor is pulled once (counted); a bfloat16 tensor becomes its
    uint16 words; host arrays and CPU tensors are not copied unless they
    are strided."""
    from . import stats

    arrays, codes = [], []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.device.type != "cpu":
                t = t.contiguous().cpu()
                stats.note_d2h(t.numel() * t.element_size())
            if t.dtype is torch.bfloat16:
                a = np.ascontiguousarray(t.view(torch.int16).numpy()).view(
                    np.uint16)
                code = _BF16_CODE
            else:
                a = np.ascontiguousarray(t.numpy())
                code = _NP_TO_CODE[a.dtype]
        else:
            a = np.ascontiguousarray(np.asarray(t))
            code = _NP_TO_CODE.get(a.dtype)
            if code is None:  # exotic dtype spelling: slow resolution
                code = _DTYPE_CODES[DataType.from_any(a.dtype)]
        arrays.append(a)
        codes.append(code)
    return arrays, codes


def _bf16_view(words: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns as a CPU bfloat16 tensor sharing their memory
    (the array, and through it the frame, stays alive with the tensor)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only frames
        return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)


def frame_nbytes(parts: List[memoryview]) -> int:
    return sum(memoryview(p).nbytes for p in parts)


def frame_overhead(n_tensors: int) -> int:
    """Bytes of a dense frame of ``n_tensors`` besides its tensor payloads
    and its meta sidecar: the header and the tensor table."""
    return _HEADER.size + n_tensors * _TENTRY.size


def encode_frame_bytes(buf: Buffer, extra_meta: Optional[dict] = None
                       ) -> memoryview:
    """One-gather owning form of :func:`encode_frame` for consumers that
    need a single contiguous frame (shm slot staging, tests)."""
    return gather_parts(encode_frame(buf, extra_meta))


def gather_parts(parts: List[memoryview]) -> memoryview:
    """Concatenate scatter-gather parts with one native memcpy pass."""
    from .. import native

    return memoryview(native.gather(
        [np.frombuffer(p, np.uint8) for p in parts]).data)


def owning_message(item) -> bytes:
    """Ownership-transfer boundary for transports that require an
    immutable owning message object (grpc). Owning ``bytes`` pass
    through UN-copied; a borrowed memoryview/ndarray frame pays exactly
    the one copy that transfers ownership."""
    if type(item) is bytes:
        return item
    return b"".join((memoryview(item).cast("B"),))


def owning_tagged(tag: bytes, payload) -> bytes:
    """``tag + payload`` as one owning message in a single gather copy
    (the old ``tag + bytes(payload)`` spelling paid two)."""
    return b"".join((tag, memoryview(payload).cast("B")))


def decode_frame(blob, copy: bool = True) -> Buffer:
    """Deserialize one NNSB frame from any contiguous byte buffer.

    ``copy=False`` returns tensors as zero-copy views over ``blob`` —
    only safe when the caller owns the blob for the buffer's lifetime
    (a freshly-received socket payload); shm slot readers must pass
    ``copy=True`` because the slot is recycled after release. Raises
    :class:`FrameError` (never a hang, never a silent short frame) on
    any truncation."""
    view = memoryview(blob).cast("B")
    r = _Reader(view)
    magic, version, _flags, n, meta_len, pts = r.unpack(
        _HEADER, "frame header")
    if magic != MAGIC:
        raise FrameError("bad binary frame magic")
    if version != VERSION:
        raise FrameError(f"unsupported binary frame version {version}")
    # hostile-peer bounds (docs/transport.md): wire-derived counts are
    # validated against the declared limits BEFORE they drive a loop or
    # an allocation — the limits are shared with the NNST codec
    if n > MAX_TENSORS:
        raise FrameError(
            f"frame declares {n} tensors (limit {MAX_TENSORS})")
    if meta_len > MAX_META_BYTES:
        raise FrameError(
            f"frame declares {meta_len}B meta (limit {MAX_META_BYTES})")
    entries = [r.unpack(_TENTRY, "tensor table") for _ in range(n)]
    tensors: List[np.ndarray] = []
    specs: List[TensorSpec] = []
    for ti, (code, rank, tflags, extra, nbytes, *dims) in enumerate(entries):
        coded = _CODE_NP.get(code)
        if coded is None:
            raise FrameError(f"tensor {ti}: unknown dtype code {code}")
        dtype, np_dtype, itemsize = coded
        if rank > MAX_RANK:
            raise FrameError(f"tensor {ti}: rank {rank} > {MAX_RANK}")
        shape = tuple(int(d) for d in dims[:rank])
        if nbytes > MAX_PAYLOAD_BYTES:
            raise FrameError(
                f"tensor {ti}: {nbytes}B payload declared "
                f"(limit {MAX_PAYLOAD_BYTES})")
        raw = r.take(nbytes, f"tensor {ti} payload")
        if tflags & _TFLAG_SPARSE:
            if len(tensors) != 2 * len(specs):
                raise FrameError(
                    f"tensor {ti}: sparse/dense mix in one frame")
            nnz = extra
            if nnz * (4 + itemsize) > nbytes:
                raise FrameError(
                    f"tensor {ti}: torn sparse payload ({nbytes} bytes "
                    f"for {nnz} idx/value pairs)")
            idx = np.frombuffer(raw, np.int32, count=nnz)
            vals = np.frombuffer(raw, np_dtype or np.uint16, count=nnz,
                                 offset=idx.nbytes).copy()
            tensors.extend([idx.copy(), vals if np_dtype is not None
                            else _bf16_view(vals)])
            specs.append(TensorSpec(shape, dtype))
        else:
            if specs:
                raise FrameError(
                    f"tensor {ti}: sparse/dense mix in one frame")
            count = 1
            for d in shape:
                count *= d
            if count * itemsize != nbytes:
                raise FrameError(
                    f"tensor {ti}: table claims {nbytes} bytes for "
                    f"{shape} {dtype.value}")
            a = np.frombuffer(raw, np_dtype or np.uint16,
                              count=count).reshape(shape or ())
            if copy:
                a = a.copy()
            tensors.append(a if np_dtype is not None else _bf16_view(a))
    meta_view = r.take(meta_len, "meta sidecar")
    if r.off != view.nbytes:
        # the frame must account for every byte: trailing garbage means
        # the sender and this decoder disagree about the layout
        raise FrameError(
            f"frame has {view.nbytes - r.off} trailing bytes past the "
            f"meta sidecar")
    meta = _unpack_meta(meta_view) if meta_len else {}
    out = Buffer(tensors, pts=None if math.isnan(pts) else pts)
    out.meta.update(meta)
    if specs:
        out.meta[SPARSE_META_KEY] = specs
    _note_wire_bytes("wire:decode", r.off)
    return out


def _note_wire_bytes(stage: str, nbytes: int) -> None:
    """NNS_XFERCHECK byte accounting at the codec choke point — the same
    ledger stages the NNST codec reports under, so binary-vs-JSON wire
    volume is one ``xfer_report`` diff. The NNS_WIREFUZZ scorekeeper
    shares the choke point: every clean encode/decode reports here while
    the fuzzer is armed (its byte-parity denominator)."""
    _san = _sys.modules.get("nnstreamer_tpu_torch.analysis.sanitizer")
    if _san is None:
        return
    if _san.XFER:
        _san.note_transfer(stage, "host", nbytes)
    if _san.WIREFUZZ:
        _san.note_frame_event(stage, nbytes)


# ---------------------------------------------------------------------------
# wire-format negotiation — an extra caps structure on the handshake
# ---------------------------------------------------------------------------
# The client appends ``other/nns-wire,formats={binary,json},host=<name>``
# to its CAPABILITY payload. An old server's accept gate still matches
# (caps intersection is any-pair, and it replies its own caps without
# the structure → the client stays on json). A new server strips the
# structure before the accept gate, picks a format, and appends
# ``other/nns-wire,selected=<fmt>[,shm=1]`` to its reply — only when the
# client offered, so an old client never sees it.

WIRE_MIME = "other/nns-wire"
FORMAT_BINARY = "binary"
FORMAT_JSON = "json"


def offer_caps(caps_str: str, formats: Tuple[str, ...] = (FORMAT_BINARY,
                                                          FORMAT_JSON),
               shm_host: Optional[str] = None) -> str:
    fields = [f"formats={{{','.join(formats)}}}"]
    if shm_host:
        fields.append(f"shmhost={shm_host}")
    return f"{caps_str};{WIRE_MIME},{','.join(fields)}"


def reply_caps(caps_str: str, selected: str,
               shm_ok: bool = False) -> str:
    fields = [f"selected={selected}"]
    if shm_ok:
        fields.append("shm=1")
    return f"{caps_str};{WIRE_MIME},{','.join(fields)}"


def split_wire_caps(caps) -> Tuple["object", Optional[dict]]:
    """(caps without the wire structure, wire fields or None). Accepts a
    parsed ``Caps``; tolerates structure order and absence."""
    from ..core.caps import Caps

    base = []
    wire = None
    for s in caps.structures:
        if s.media_type == WIRE_MIME:
            wire = s.as_dict()
        else:
            base.append(s)
    if wire is None:
        return caps, None
    return Caps(tuple(base)), wire


def offered_formats(wire_fields: dict) -> Tuple[str, ...]:
    v = wire_fields.get("formats")
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    values = getattr(v, "values", None)  # caps ValueList
    if values is not None:
        return tuple(str(x) for x in values)
    return (str(v),)
