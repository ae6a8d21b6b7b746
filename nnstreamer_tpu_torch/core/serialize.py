"""Tensor frame wire format (L1/L5 shared).

One binary framing used everywhere the reference uses flatbuf/protobuf/
flexbuf serialization (ext/nnstreamer/tensor_decoder/tensordec-{flatbuf,
flexbuf,protobuf}.*, the mqtt 1024-byte header gst/mqtt/mqttcommon.h:49-61,
and the nns-edge data list) — header + per-tensor {flags, dtype, shape,
payload}:

  magic  "NNST"  | u16 version | u32 n_tensors | f64 pts (nan=None) |
  u32 meta_len | meta JSON | per tensor:
    v1:  u8 dtype_len | dtype name | u8 rank | u64*rank dims | u64 nbytes | raw
    v2:  u8 flags | <v1 tensor header> | payload

``flags`` bit0 = sparse: dtype/dims describe the DENSE tensor and the
payload is ``u32 nnz | int32 idx[nnz] | value[nnz]`` — the COO form of the
reference's per-memory ``GstTensorMetaInfo.sparse_info`` header
(gst/nnstreamer/elements/gsttensor_sparseutil.c:116,
include/tensor_typedef.h:280), so a sparse stream survives every process
boundary (query/edge/mqtt/grpc) exactly like the reference's does. Dense
frames are EMITTED as v1 so not-yet-upgraded peers keep reading them
during a rolling upgrade; both versions are accepted on read.

Buffer ``meta`` rides as JSON: numpy scalars/arrays are coerced, anything
else non-serializable raises (a silent drop turned sparse frames into
garbage downstream once — VERDICT r02 weak #3).

The bytes are nnstreamer_tpu's, so a frame packed by either package
unpacks in the other. Torch tensors are packed from the host: a buffer of
CUDA tensors is pulled once (``Buffer.as_numpy``). bfloat16, which numpy
lacks, travels as its raw 2-byte words and unpacks as a CPU
``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import json
import math
import struct
import sys as _sys
from typing import List, Optional

import numpy as np
import torch

from .buffer import Buffer
from .tensors import DataType, TensorSpec

MAGIC = b"NNST"
VERSION = 2
_FLAG_SPARSE = 0x01

# declared hostile-peer limits (docs/transport.md "hostile peer"
# contract): every wire-derived size is checked against these BEFORE it
# drives an allocation or a loop, and the violation raises the decoder's
# typed error (ValueError here; transport/frame.py imports these and
# raises FrameError, a ValueError subclass). A 4-byte count field from a
# corrupt or hostile peer must never become a multi-GB allocation.
MAX_TENSORS = 256
MAX_META_BYTES = 1 << 20        # 1 MiB of JSON/tagged-binary meta
MAX_PAYLOAD_BYTES = 1 << 33     # 8 GiB total tensor payload per frame

# both sides of the v2/sparse header fields share these layouts — one
# source of truth, so encoder and decoder cannot drift independently
_FLAGS_DTLEN = struct.Struct("<BB")   # u8 flags | u8 dtype-name length
_NBYTES_NNZ = struct.Struct("<QI")    # u64 nbytes | u32 nnz (sparse)

# meta key consumed into per-tensor sparse headers rather than the JSON blob
SPARSE_META_KEY = "sparse_specs"


# ndarrays in meta coerce to JSON lists only up to this many elements;
# anything larger (e.g. the image-segment decoder's full H×W class_map,
# an in-process convenience) would inflate every frame with megabytes of
# JSON text — such keys are dropped from the wire with a warning (ship
# large arrays as tensors); all OTHER non-serializable meta raises
_META_ARRAY_MAX = 256
_warned_meta_keys = set()


def _meta_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        if o.size > _META_ARRAY_MAX:
            # nested inside a list/dict value the top-level drop can't see:
            # refuse loudly rather than inflate the frame
            raise TypeError(
                f"ndarray of {o.size} elements nested in meta "
                f"(>{_META_ARRAY_MAX}); ship large arrays as tensors")
        return o.tolist()
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    raise TypeError(f"{type(o).__name__} is not wire-serializable")


def _encode_meta(meta: dict) -> bytes:
    """JSON-encode buffer meta, coercing numpy values; raise naming the
    offending keys instead of silently dropping them. Oversized ndarray
    values are dropped loudly (warning, once per key)."""
    from ..utils.log import logger

    items = {}
    # sorted: the emitted bytes must not depend on dict insertion order
    # (canonical encoding — two peers packing the same meta produce the
    # same frame, and wirefuzz byte-parity checks rely on it)
    for k, v in sorted(meta.items(), key=lambda kv: str(kv[0])):
        if k == SPARSE_META_KEY:
            continue  # carried in the per-tensor headers
        if isinstance(v, np.ndarray) and v.size > _META_ARRAY_MAX:
            if k not in _warned_meta_keys:
                _warned_meta_keys.add(k)
                logger.warning(
                    "meta['%s'] (%d-element ndarray) dropped from the wire: "
                    "arrays >%d elements must travel as tensors, not meta",
                    k, v.size, _META_ARRAY_MAX)
            continue
        items[str(k)] = v
    try:
        return json.dumps(items, default=_meta_default,
                          sort_keys=True).encode()
    except (TypeError, ValueError):
        bad = []
        for k, v in sorted(items.items()):
            try:
                json.dumps(v, default=_meta_default)
            except (TypeError, ValueError):
                bad.append(k)
        raise TypeError(
            f"buffer meta key(s) {bad} are not wire-serializable; "
            "convert to JSON-able values before crossing a process boundary")


def _host_array(t) -> np.ndarray:
    """A host tensor as a C-contiguous ndarray; bfloat16 as uint16 words
    (its dtype is read from the tensor itself by :func:`_dtype_of`)."""
    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bfloat16:
            t = t.view(torch.uint16)
        t = t.numpy()
    # ascontiguousarray gives a 0-d tensor rank 1, as nnstreamer_tpu packs it
    return np.ascontiguousarray(np.asarray(t))


def _dtype_of(t) -> DataType:
    return DataType.from_any(t.dtype)


def _from_wire(blob, dtype: DataType, count: int, offset: int):
    """``count`` elements of ``dtype`` at ``offset``, copied out of the
    blob: an ndarray, or a CPU torch tensor for bfloat16."""
    if dtype is DataType.BFLOAT16:
        words = np.frombuffer(blob, np.uint16, count=count, offset=offset)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(blob, dtype.np_dtype, count=count,
                         offset=offset).copy()


def pack_tensors(buf: Buffer, extra_meta: Optional[dict] = None) -> memoryview:
    """Serialize one frame into a single freshly-gathered buffer.

    Headers are built in Python (tiny); tensor payloads are copied exactly
    once, by one ``np.concatenate`` gather. Returns a ``memoryview`` (call
    ``bytes()`` if an owning immutable copy is needed).

    Sparse frames (``buf.meta['sparse_specs']`` from tensor_sparse_enc,
    tensors laid out as ``idx0, val0, idx1, val1, ...``) are written with
    the sparse flag: one wire tensor per DENSE tensor, dense spec in the
    header, COO payload.
    """
    host = buf.as_numpy().tensors
    arrays = [_host_array(t) for t in host]
    dtypes = [_dtype_of(t) for t in host]
    meta = dict(buf.meta)
    if extra_meta:
        meta.update(extra_meta)
    specs = meta.get(SPARSE_META_KEY)
    meta_blob = _encode_meta(meta)
    n_wire = len(arrays) if specs is None else len(specs)
    if specs is not None and len(arrays) != 2 * len(specs):
        raise ValueError(
            f"sparse frame carries {len(arrays)} arrays for {len(specs)} specs "
            "(want idx/value pairs)")
    # dense frames go out as v1 (no flags byte) so not-yet-upgraded peers
    # keep reading them during a rolling upgrade; only sparse needs v2
    version = 1 if specs is None else VERSION
    parts: List[np.ndarray] = [_bview(
        MAGIC
        + struct.pack("<HIdI", version, n_wire,
                      math.nan if buf.pts is None else buf.pts, len(meta_blob))
        + meta_blob
    )]
    if specs is None:
        for a, dtype in zip(arrays, dtypes):
            dt = dtype.value.encode()
            parts.append(_bview(
                struct.pack("<B", len(dt)) + dt + struct.pack("<B", a.ndim)
                + struct.pack(f"<{a.ndim}Q", *a.shape)
                + struct.pack("<Q", a.nbytes)))
            parts.append(a.reshape(-1).view(np.uint8))
    else:
        for i, spec in enumerate(specs):
            idx = np.ascontiguousarray(arrays[2 * i], np.int32)
            vals = arrays[2 * i + 1]
            dtype = DataType.from_any(spec.dtype)
            if dtypes[2 * i + 1] is not dtype:
                raise ValueError(
                    f"sparse tensor {i}: values dtype {vals.dtype} != "
                    f"dense spec dtype {dtype.value}")
            if idx.size != vals.size:
                raise ValueError(
                    f"sparse tensor {i}: {idx.size} indices but "
                    f"{vals.size} values")
            shape = tuple(int(d) for d in spec.shape)
            nbytes = 4 + idx.nbytes + vals.nbytes
            dt = dtype.value.encode()
            parts.append(_bview(
                _FLAGS_DTLEN.pack(_FLAG_SPARSE, len(dt)) + dt
                + struct.pack("<B", len(shape))
                + struct.pack(f"<{len(shape)}Q", *shape)
                + _NBYTES_NNZ.pack(nbytes, idx.size)))
            parts.append(idx.view(np.uint8))
            parts.append(vals.reshape(-1).view(np.uint8))
    frame = np.concatenate(parts).data
    _note_wire_bytes("wire:encode", frame.nbytes)
    return frame


def _note_wire_bytes(stage: str, nbytes: int) -> None:
    """NNS_XFERCHECK byte accounting for the codec choke point. A
    sys.modules lookup, not an import: core/ must not import the
    analysis package (cycle risk); one dict-get + attribute check when
    the sanitizer is off."""
    _san = _sys.modules.get("nnstreamer_tpu_torch.analysis.sanitizer")
    if _san is not None and _san.XFER:
        _san.note_transfer(stage, "host", nbytes)


def _bview(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8)


def unpack_tensors(blob) -> Buffer:
    """Deserialize one frame from any contiguous byte buffer (bytes,
    bytearray, memoryview, or uint8 ndarray). Accepts wire v1 (no flags
    byte) and v2. A sparse frame reconstructs the tensor_sparse_enc layout:
    idx/value array pairs + ``meta['sparse_specs']``."""
    blob = memoryview(blob).cast("B")
    if bytes(blob[:4]) != MAGIC:
        raise ValueError("bad tensor frame magic")
    off = 4
    try:
        version, n, pts, meta_len = struct.unpack_from("<HIdI", blob, off)
        if version not in (1, VERSION):
            raise ValueError(f"unsupported frame version {version}")
        off += struct.calcsize("<HIdI")
        # hostile-peer bounds: every wire-derived size is validated
        # against the declared limit (and against what actually arrived)
        # BEFORE it drives an allocation or a loop
        if n > MAX_TENSORS:
            raise ValueError(
                f"frame declares {n} tensors (limit {MAX_TENSORS})")
        if meta_len > MAX_META_BYTES or off + meta_len > len(blob):
            raise ValueError(
                f"torn/oversized meta: {meta_len} bytes declared, "
                f"{len(blob) - off} available (limit {MAX_META_BYTES})")
        meta = json.loads(bytes(blob[off:off + meta_len]) or b"{}")
        off += meta_len
        tensors: List[np.ndarray] = []
        specs: List[TensorSpec] = []
        for ti in range(n):
            if version >= 2:
                flags, dt_len = _FLAGS_DTLEN.unpack_from(blob, off)
                off += _FLAGS_DTLEN.size
            else:
                flags = 0
                (dt_len,) = struct.unpack_from("<B", blob, off)
                off += 1
            dtype = DataType(bytes(blob[off:off + dt_len]).decode())
            off += dt_len
            (rank,) = struct.unpack_from("<B", blob, off)
            off += 1
            shape = struct.unpack_from(f"<{rank}Q", blob, off)
            off += 8 * rank
            if flags & _FLAG_SPARSE:
                # a frame is all-sparse or all-dense (tensor_sparse_enc
                # layout pairs idx/values positionally — mixing would
                # misalign them)
                if len(tensors) != 2 * len(specs):
                    raise ValueError(
                        f"tensor {ti}: sparse/dense mix in one frame")
                nbytes, nnz = _NBYTES_NNZ.unpack_from(blob, off)
                off += 8  # nnz is part of the nbytes-counted payload
                itemsize = dtype.itemsize
                if (nbytes > MAX_PAYLOAD_BYTES
                        or 4 + nnz * (4 + itemsize) > nbytes
                        or off + nbytes > len(blob)):
                    raise ValueError(
                        f"tensor {ti}: torn/oversized sparse payload "
                        f"({nnz} nnz, {nbytes} bytes declared, "
                        f"{len(blob) - off} available)")
                idx = np.frombuffer(blob, np.int32, count=nnz,
                                    offset=off + 4)
                vals = _from_wire(blob, dtype, nnz, off + 4 + idx.nbytes)
                tensors.extend([idx.copy(), vals])
                specs.append(TensorSpec(shape, dtype))
            else:
                if specs:
                    raise ValueError(
                        f"tensor {ti}: sparse/dense mix in one frame")
                (nbytes,) = struct.unpack_from("<Q", blob, off)
                off += 8
                count = 1
                for d in shape:
                    count *= int(d)  # Python ints: no silent overflow
                itemsize = dtype.itemsize
                if (nbytes > MAX_PAYLOAD_BYTES
                        or count * itemsize != nbytes
                        or off + nbytes > len(blob)):
                    raise ValueError(
                        f"tensor {ti}: payload mismatch (shape {shape} "
                        f"wants {count * itemsize} bytes, {nbytes} "
                        f"declared, {len(blob) - off} available)")
                a = _from_wire(blob, dtype, count, off)
                tensors.append(a.reshape(shape or ()))
            off += nbytes
    except (struct.error, UnicodeDecodeError) as e:
        # a truncated/corrupt frame must surface as the decoder's TYPED
        # error, never a bare struct.error killing a reader thread
        raise ValueError(f"torn tensor frame: {e}") from e
    out = Buffer(tensors, pts=None if math.isnan(pts) else pts)
    out.meta.update(meta)
    if specs:
        out.meta[SPARSE_META_KEY] = specs
    _note_wire_bytes("wire:decode", off)
    return out
