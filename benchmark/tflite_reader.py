"""A small reader of the ``.tflite`` flatbuffer, for the plain reference.

It reads what an int8 image classifier needs: the buffers, the first
subgraph's tensors (shape, type, buffer, quantization), its inputs,
outputs and operators, the operator codes and the options of CONV_2D,
DEPTHWISE_CONV_2D, ADD, MEAN and FULLY_CONNECTED. Field ids follow
TFLite's ``schema.fbs``: field ``i`` of a table sits at vtable slot
``4 + 2*i``. It is the benchmark's own copy, kept apart from the program
under test so that a change there cannot change the yardstick.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# BuiltinOperator codes of the ops the reference executes
OPCODES = {0: "ADD", 3: "CONV_2D", 4: "DEPTHWISE_CONV_2D",
           9: "FULLY_CONNECTED", 40: "MEAN"}
# TensorType
TYPES = {0: np.float32, 2: np.int32, 3: np.uint8, 4: np.int64, 9: np.int8}
# option fields: name -> (field id, struct format)
_OPTIONS = {
    "CONV_2D": {"padding": (0, "b"), "stride_w": (1, "i"),
                "stride_h": (2, "i"), "activation": (3, "b"),
                "dilation_w": (4, "i"), "dilation_h": (5, "i")},
    "DEPTHWISE_CONV_2D": {"padding": (0, "b"), "stride_w": (1, "i"),
                          "stride_h": (2, "i"), "depth_multiplier": (3, "i"),
                          "activation": (4, "b"), "dilation_w": (5, "i"),
                          "dilation_h": (6, "i")},
    "ADD": {"activation": (0, "b")},
    "MEAN": {"keep_dims": (0, "b")},
    "FULLY_CONNECTED": {"activation": (0, "b"), "weights_format": (1, "b"),
                        "keep_num_dims": (2, "b")},
}
_DEFAULTS = {"stride_w": 1, "stride_h": 1, "dilation_w": 1, "dilation_h": 1,
             "depth_multiplier": 1}


class _Table:
    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, i: int) -> int:
        slot = 4 + 2 * i
        if slot >= self.vt_len:
            return 0
        return struct.unpack_from("<H", self.buf, self.vt + slot)[0]

    def scalar(self, i: int, fmt: str, default=0):
        off = self._off(i)
        if not off:
            return default
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0]

    def _ref(self, i: int) -> Optional[int]:
        off = self._off(i)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, i: int) -> Optional["_Table"]:
        at = self._ref(i)
        return None if at is None else _Table(self.buf, at)

    def vector(self, i: int, dtype) -> np.ndarray:
        at = self._ref(i)
        if at is None:
            return np.zeros(0, dtype)
        n = struct.unpack_from("<I", self.buf, at)[0]
        return np.frombuffer(self.buf, dtype, n, at + 4)

    def tables(self, i: int) -> List["_Table"]:
        at = self._ref(i)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for k in range(n):
            p = at + 4 + 4 * k
            out.append(_Table(self.buf, p + struct.unpack_from("<I", self.buf, p)[0]))
        return out


@dataclass
class TensorDef:
    shape: Tuple[int, ...]
    dtype: type
    data: Optional[np.ndarray]          # constant contents, None for activations
    scale: np.ndarray                   # float32, one or one per channel
    zero_point: np.ndarray              # int64


@dataclass
class OpDef:
    op: str
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]
    options: Dict[str, int]


@dataclass
class Graph:
    tensors: List[TensorDef]
    ops: List[OpDef]
    inputs: Tuple[int, ...]
    outputs: Tuple[int, ...]


def read_graph(data: bytes) -> Graph:
    """The first subgraph of a ``.tflite`` file. Raises ValueError on an
    operator the reference does not execute."""
    buf = memoryview(data)
    root = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    codes = [max(c.scalar(3, "i", 0), c.scalar(0, "b", 0))
             for c in root.tables(1)]
    buffers = [b.vector(0, np.uint8) for b in root.tables(4)]
    sg = root.tables(2)[0]
    tensors = []
    for t in sg.tables(0):
        dtype = TYPES[t.scalar(1, "b", 0)]
        shape = tuple(int(s) for s in t.vector(0, np.int32))
        raw = buffers[t.scalar(2, "I", 0)]
        data_ = (np.frombuffer(raw.tobytes(), dtype).reshape(shape)
                 if raw.size else None)
        q = t.table(4)
        scale = q.vector(2, np.float32) if q is not None else np.zeros(0, np.float32)
        zp = q.vector(3, np.int64) if q is not None else np.zeros(0, np.int64)
        tensors.append(TensorDef(shape, dtype, data_, scale.copy(), zp.copy()))
    ops = []
    for o in sg.tables(3):
        code = codes[o.scalar(0, "I", 0)]
        if code not in OPCODES:
            raise ValueError(f"tflite reference: operator code {code} is not "
                             f"one of {sorted(OPCODES.values())}")
        name = OPCODES[code]
        opt_t = o.table(4)
        opts = {}
        for key, (fid, fmt) in _OPTIONS[name].items():
            dflt = _DEFAULTS.get(key, 0)
            opts[key] = int(opt_t.scalar(fid, fmt, dflt)) if opt_t else dflt
        ops.append(OpDef(name, tuple(int(i) for i in o.vector(1, np.int32)),
                         tuple(int(i) for i in o.vector(2, np.int32)), opts))
    return Graph(tensors, ops, tuple(int(i) for i in sg.vector(1, np.int32)),
                 tuple(int(i) for i in sg.vector(2, np.int32)))
