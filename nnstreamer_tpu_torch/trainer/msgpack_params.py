"""Parameter files in flax's msgpack format, read and written without
flax or msgpack.

nnstreamer_tpu's trainer saves its params with
``flax.serialization.to_bytes``: a msgpack map of the parameter tree (lists
become maps keyed "0", "1", ...), each array an ext of type 1 holding the
msgpack triple (shape, dtype name, C-order bytes), a numpy scalar an ext of
type 3, and an array over 2**30 bytes a map ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {...}}``. ``loads`` reads that (the subset
of msgpack flax writes), ``restore`` fits it into a target tree of tensors,
and ``dumps`` writes a tree of tensors the same way, so a model trained by
either package resumes in the other.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(data)
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise ValueError("msgpack: truncated data")
        out = self.b[self.i:self.i + n].tobytes()
        self.i += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in numbers:
            return self.unpack(numbers[t])
        raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype, raw = _Reader(payload).obj()
        return _array(tuple(shape), dtype, raw)


def _array(shape: Tuple[int, ...], dtype: str, raw: bytes) -> Any:
    """numpy for numpy's dtypes; bfloat16 (an ml_dtypes name) as a torch
    tensor from its bit patterns."""
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
        return bits.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate([np.asarray(c) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def loads(data: bytes) -> Any:
    """flax ``to_bytes`` output → nested dicts of numpy arrays."""
    r = _Reader(data)
    out = r.obj()
    if r.i != len(r.b):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(out)


def restore(target: Any, state: Any, path: str = "") -> Any:
    """Fit a ``loads`` tree into ``target`` (dicts, lists and tensors):
    the target's structure, shapes, dtypes and devices; raises on a
    missing key or a shape mismatch."""
    if isinstance(target, dict):
        missing = set(target) - set(state)
        if missing:
            raise KeyError(f"params file lacks {sorted(missing)} at "
                           f"'{path or '/'}'")
        return {k: restore(v, state[k], f"{path}/{k}")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(restore(v, state[str(i)], f"{path}/{i}")
                            for i, v in enumerate(target))
    t = (state if isinstance(state, torch.Tensor)
         else torch.from_numpy(np.array(state)))
    if tuple(t.shape) != tuple(target.shape):
        raise ValueError(f"params file: {path} has shape {tuple(t.shape)}, "
                         f"the model {tuple(target.shape)}")
    return t.to(device=target.device, dtype=target.dtype)


def _pack_obj(out: bytearray, x: Any) -> None:
    if isinstance(x, str):
        b = x.encode()
        if len(b) < 32:
            out.append(0xA0 | len(b))
        else:
            out += b"\xdb" + struct.pack(">I", len(b))
        out += b
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        if 0 <= x <= 0x7F:
            out.append(x)
        else:
            out += b"\xd3" + struct.pack(">q", x)
    elif isinstance(x, bytes):
        out += b"\xc6" + struct.pack(">I", len(x)) + x
    elif isinstance(x, (list, tuple)):
        out += b"\xdd" + struct.pack(">I", len(x))
        for v in x:
            _pack_obj(out, v)
    elif isinstance(x, dict):
        out += b"\xdf" + struct.pack(">I", len(x))
        for k, v in x.items():
            _pack_obj(out, k)
            _pack_obj(out, v)
    elif isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            name, raw = a.dtype.name, a.tobytes()
        inner = bytearray()
        _pack_obj(inner, [list(t.shape), name, raw])
        out += b"\xc9" + struct.pack(">I", len(inner))
        out += struct.pack(">b", _EXT_NDARRAY) + inner
    else:
        raise TypeError(f"msgpack: cannot pack {type(x).__name__}")


def dumps(tree: Any) -> bytes:
    """A tree of tensors → flax ``to_bytes`` bytes (lists as maps keyed
    "0", "1", ..., as flax's state dicts have them)."""
    def state_dict(t):
        if isinstance(t, dict):
            return {str(k): state_dict(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return {str(i): state_dict(v) for i, v in enumerate(t)}
        return t

    out = bytearray()
    _pack_obj(out, state_dict(tree))
    return bytes(out)
