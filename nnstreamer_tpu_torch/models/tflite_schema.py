"""Reader of the ``.tflite`` flatbuffer schema, in pure Python.

nnstreamer_tpu's importer reads model files through TensorFlow's generated
schema bindings; the port runs where TensorFlow is not installed, so it
reads the flatbuffer itself with ``struct`` and ``np.frombuffer`` over the
file's bytes. It covers what ``models/tflite_import.py`` reads: the model's
buffers, subgraphs and operator codes, each subgraph's tensors (shape,
type, buffer, quantization), inputs, outputs and operators, and each
operator's builtin-options table.

Field ids follow tflite's ``schema.fbs``: a table's field ``i`` sits at
vtable slot ``4 + 2*i``. Readers return plain Python and numpy values;
vectors are read-only views of the model bytes.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# BuiltinOperator, indexed by code (tflite schema.fbs enum order)
BUILTIN_OPERATORS: Tuple[str, ...] = tuple("""
ADD AVERAGE_POOL_2D CONCATENATION CONV_2D DEPTHWISE_CONV_2D DEPTH_TO_SPACE
DEQUANTIZE EMBEDDING_LOOKUP FLOOR FULLY_CONNECTED HASHTABLE_LOOKUP
L2_NORMALIZATION L2_POOL_2D LOCAL_RESPONSE_NORMALIZATION LOGISTIC
LSH_PROJECTION LSTM MAX_POOL_2D MUL RELU RELU_N1_TO_1 RELU6 RESHAPE
RESIZE_BILINEAR RNN SOFTMAX SPACE_TO_DEPTH SVDF TANH CONCAT_EMBEDDINGS
SKIP_GRAM CALL CUSTOM EMBEDDING_LOOKUP_SPARSE PAD
UNIDIRECTIONAL_SEQUENCE_RNN GATHER BATCH_TO_SPACE_ND SPACE_TO_BATCH_ND
TRANSPOSE MEAN SUB DIV SQUEEZE UNIDIRECTIONAL_SEQUENCE_LSTM STRIDED_SLICE
BIDIRECTIONAL_SEQUENCE_RNN EXP TOPK_V2 SPLIT LOG_SOFTMAX DELEGATE
BIDIRECTIONAL_SEQUENCE_LSTM CAST PRELU MAXIMUM ARG_MAX MINIMUM LESS NEG
PADV2 GREATER GREATER_EQUAL LESS_EQUAL SELECT SLICE SIN TRANSPOSE_CONV
SPARSE_TO_DENSE TILE EXPAND_DIMS EQUAL NOT_EQUAL LOG SUM SQRT RSQRT SHAPE
POW ARG_MIN FAKE_QUANT REDUCE_PROD REDUCE_MAX PACK LOGICAL_OR ONE_HOT
LOGICAL_AND LOGICAL_NOT UNPACK REDUCE_MIN FLOOR_DIV REDUCE_ANY SQUARE
ZEROS_LIKE FILL FLOOR_MOD RANGE RESIZE_NEAREST_NEIGHBOR LEAKY_RELU
SQUARED_DIFFERENCE MIRROR_PAD ABS SPLIT_V UNIQUE CEIL REVERSE_V2 ADD_N
GATHER_ND COS WHERE RANK ELU REVERSE_SEQUENCE MATRIX_DIAG QUANTIZE
MATRIX_SET_DIAG ROUND HARD_SWISH IF WHILE NON_MAX_SUPPRESSION_V4
NON_MAX_SUPPRESSION_V5 SCATTER_ND SELECT_V2 DENSIFY SEGMENT_SUM BATCH_MATMUL
PLACEHOLDER_FOR_GREATER_OP_CODES CUMSUM CALL_ONCE BROADCAST_TO RFFT2D
CONV_3D IMAG REAL COMPLEX_ABS HASHTABLE HASHTABLE_FIND HASHTABLE_IMPORT
HASHTABLE_SIZE REDUCE_ALL CONV_3D_TRANSPOSE VAR_HANDLE READ_VARIABLE
ASSIGN_VARIABLE BROADCAST_ARGS RANDOM_STANDARD_NORMAL BUCKETIZE
RANDOM_UNIFORM MULTINOMIAL GELU DYNAMIC_UPDATE_SLICE RELU_0_TO_1
UNSORTED_SEGMENT_PROD UNSORTED_SEGMENT_MAX UNSORTED_SEGMENT_SUM ATAN2
UNSORTED_SEGMENT_MIN SIGN BITCAST BITWISE_XOR RIGHT_SHIFT STABLEHLO_LOGISTIC
STABLEHLO_ADD STABLEHLO_DIVIDE STABLEHLO_MULTIPLY STABLEHLO_MAXIMUM
STABLEHLO_RESHAPE STABLEHLO_CLAMP STABLEHLO_CONCATENATE
STABLEHLO_BROADCAST_IN_DIM STABLEHLO_CONVOLUTION STABLEHLO_SLICE
STABLEHLO_CUSTOM_CALL STABLEHLO_REDUCE STABLEHLO_ABS STABLEHLO_AND
STABLEHLO_COSINE STABLEHLO_EXPONENTIAL STABLEHLO_FLOOR STABLEHLO_LOG
STABLEHLO_MINIMUM STABLEHLO_NEGATE STABLEHLO_OR STABLEHLO_POWER
STABLEHLO_REMAINDER STABLEHLO_RSQRT STABLEHLO_SELECT STABLEHLO_SUBTRACT
STABLEHLO_TANH STABLEHLO_SCATTER STABLEHLO_COMPARE STABLEHLO_CONVERT
STABLEHLO_DYNAMIC_SLICE STABLEHLO_DYNAMIC_UPDATE_SLICE STABLEHLO_PAD
STABLEHLO_IOTA STABLEHLO_DOT_GENERAL STABLEHLO_REDUCE_WINDOW STABLEHLO_SORT
STABLEHLO_WHILE STABLEHLO_GATHER STABLEHLO_TRANSPOSE DILATE
STABLEHLO_RNG_BIT_GENERATOR REDUCE_WINDOW STABLEHLO_COMPOSITE
STABLEHLO_SHIFT_LEFT STABLEHLO_CBRT STABLEHLO_CASE
""".split())


def builtin_name(code: int) -> str:
    """The operator's name, or ``str(code)`` for a code this table lacks."""
    return BUILTIN_OPERATORS[code] if 0 <= code < len(BUILTIN_OPERATORS) \
        else str(code)


# numpy dtype of each scalar kind a field may hold
_SCALAR = {"bool": ("<B", 1), "int8": ("<b", 1), "uint8": ("<B", 1),
           "int32": ("<i", 4), "uint32": ("<I", 4), "int64": ("<q", 8),
           "uint64": ("<Q", 8), "float32": ("<f", 4)}
_VEC_DTYPE = {"int32": "<i4", "int64": "<i8", "float32": "<f4",
              "uint8": "u1"}

# builtin-options tables: name -> (union type id, {field: (id, kind,
# default)}); the defaults are schema.fbs's
OPTIONS: Dict[str, Tuple[int, Dict[str, Tuple[int, str, Any]]]] = {
    "Conv2DOptions": (1, {
        "padding": (0, "int8", 0), "stride_w": (1, "int32", 0),
        "stride_h": (2, "int32", 0),
        "fused_activation_function": (3, "int8", 0),
        "dilation_w_factor": (4, "int32", 1),
        "dilation_h_factor": (5, "int32", 1)}),
    "DepthwiseConv2DOptions": (2, {
        "padding": (0, "int8", 0), "stride_w": (1, "int32", 0),
        "stride_h": (2, "int32", 0), "depth_multiplier": (3, "int32", 0),
        "fused_activation_function": (4, "int8", 0),
        "dilation_w_factor": (5, "int32", 1),
        "dilation_h_factor": (6, "int32", 1)}),
    "Pool2DOptions": (5, {
        "padding": (0, "int8", 0), "stride_w": (1, "int32", 0),
        "stride_h": (2, "int32", 0), "filter_width": (3, "int32", 0),
        "filter_height": (4, "int32", 0),
        "fused_activation_function": (5, "int8", 0)}),
    "FullyConnectedOptions": (8, {
        "fused_activation_function": (0, "int8", 0),
        "keep_num_dims": (2, "bool", False)}),
    "SoftmaxOptions": (9, {"beta": (0, "float32", 0.0)}),
    "ConcatenationOptions": (10, {
        "axis": (0, "int32", 0),
        "fused_activation_function": (1, "int8", 0)}),
    "AddOptions": (11, {"fused_activation_function": (0, "int8", 0)}),
    "ResizeBilinearOptions": (15, {
        "align_corners": (2, "bool", False),
        "half_pixel_centers": (3, "bool", False)}),
    "ReshapeOptions": (17, {"new_shape": (0, "[int32]", None)}),
    "SpaceToDepthOptions": (19, {"block_size": (0, "int32", 0)}),
    "MulOptions": (21, {"fused_activation_function": (0, "int8", 0)}),
    "GatherOptions": (23, {"axis": (0, "int32", 0),
                           "batch_dims": (1, "int32", 0)}),
    "ReducerOptions": (27, {"keep_dims": (0, "bool", False)}),
    "SubOptions": (28, {"fused_activation_function": (0, "int8", 0)}),
    "DivOptions": (29, {"fused_activation_function": (0, "int8", 0)}),
    "SqueezeOptions": (30, {"squeeze_dims": (0, "[int32]", None)}),
    "StridedSliceOptions": (32, {
        "begin_mask": (0, "int32", 0), "end_mask": (1, "int32", 0),
        "ellipsis_mask": (2, "int32", 0), "new_axis_mask": (3, "int32", 0),
        "shrink_axis_mask": (4, "int32", 0)}),
    "SplitOptions": (35, {"num_splits": (0, "int32", 0)}),
    "TransposeConvOptions": (49, {
        "padding": (0, "int8", 0), "stride_w": (1, "int32", 0),
        "stride_h": (2, "int32", 0),
        "fused_activation_function": (3, "int8", 0)}),
    "PackOptions": (59, {"values_count": (0, "int32", 0),
                         "axis": (1, "int32", 0)}),
    "UnpackOptions": (64, {"num": (0, "int32", 0), "axis": (1, "int32", 0)}),
    "ResizeNearestNeighborOptions": (74, {
        "align_corners": (0, "bool", False),
        "half_pixel_centers": (1, "bool", False)}),
    "LeakyReluOptions": (75, {"alpha": (0, "float32", 0.0)}),
    "DepthToSpaceOptions": (94, {"block_size": (0, "int32", 0)}),
}


class _Table:
    """One flatbuffer table: ``pos`` is where its soffset to the vtable
    sits in ``buf``."""

    __slots__ = ("buf", "pos", "_vt", "_vt_len")

    def __init__(self, buf: memoryview, pos: int):
        self.buf = buf
        self.pos = pos
        self._vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self._vt_len = struct.unpack_from("<H", buf, self._vt)[0]

    def _field(self, i: int) -> int:
        """Byte offset of field ``i`` within the table, 0 when absent."""
        slot = 4 + 2 * i
        if slot >= self._vt_len:
            return 0
        return struct.unpack_from("<H", self.buf, self._vt + slot)[0]

    def _indirect(self, at: int) -> int:
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def scalar(self, i: int, kind: str, default: Any) -> Any:
        off = self._field(i)
        if not off:
            return default
        fmt, _ = _SCALAR[kind]
        v = struct.unpack_from(fmt, self.buf, self.pos + off)[0]
        if kind == "bool":
            return bool(v)
        return float(v) if kind == "float32" else int(v)

    def table(self, i: int) -> Optional["_Table"]:
        off = self._field(i)
        if not off:
            return None
        return _Table(self.buf, self._indirect(self.pos + off))

    def _vector(self, i: int) -> Tuple[int, int]:
        """(start of the elements, length) of vector field ``i``."""
        off = self._field(i)
        if not off:
            return 0, 0
        at = self._indirect(self.pos + off)
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def vector(self, i: int, kind: str) -> np.ndarray:
        """A numeric vector as a read-only numpy view (empty if absent)."""
        start, n = self._vector(i)
        dt = np.dtype(_VEC_DTYPE[kind])
        if not n:
            return np.zeros(0, dt)
        return np.frombuffer(self.buf, dt, n, start)

    def tables(self, i: int) -> List["_Table"]:
        start, n = self._vector(i)
        return [_Table(self.buf, self._indirect(start + 4 * k))
                for k in range(n)]

    def string(self, i: int) -> Optional[str]:
        off = self._field(i)
        if not off:
            return None
        at = self._indirect(self.pos + off)
        n = struct.unpack_from("<I", self.buf, at)[0]
        return bytes(self.buf[at + 4:at + 4 + n]).decode("utf-8", "replace")


class QuantizationParameters:
    def __init__(self, t: _Table):
        self.scale = t.vector(2, "float32")
        self.zero_point = t.vector(3, "int64")
        self.quantized_dimension = t.scalar(6, "int32", 0)


class Tensor:
    def __init__(self, t: _Table):
        self.shape = t.vector(0, "int32")
        self.type = t.scalar(1, "int8", 0)
        self.buffer = t.scalar(2, "uint32", 0)
        self.name = t.string(3)
        q = t.table(4)
        self.quantization = (QuantizationParameters(q)
                             if q is not None else None)


class Operator:
    def __init__(self, t: _Table):
        self.opcode_index = t.scalar(0, "uint32", 0)
        self.inputs = t.vector(1, "int32")
        self.outputs = t.vector(2, "int32")
        self.builtin_options_type = t.scalar(3, "uint8", 0)
        self._options = t.table(4)

    def options(self, name: str) -> Optional[Dict[str, Any]]:
        """The builtin-options table read as ``name`` (a key of
        :data:`OPTIONS`), or None when the operator carries none. Like the
        generated bindings, the union's type tag is not checked."""
        t = self._options
        if t is None:
            return None
        out: Dict[str, Any] = {}
        for field, (i, kind, default) in OPTIONS[name][1].items():
            if kind.startswith("["):
                out[field] = t.vector(i, kind[1:-1])
            else:
                out[field] = t.scalar(i, kind, default)
        return out


class OperatorCode:
    def __init__(self, t: _Table):
        self.deprecated_builtin_code = t.scalar(0, "int8", 0)
        self.custom_code = t.string(1)
        self.version = t.scalar(2, "int32", 1)
        self.builtin_code = t.scalar(3, "int32", 0)

    @property
    def code(self) -> int:
        """The operator's code: schema v3a keeps codes above 127 in
        ``builtin_code`` and a placeholder in the deprecated field, so the
        larger of the two is the real one."""
        return max(self.builtin_code, self.deprecated_builtin_code)


class SubGraph:
    def __init__(self, t: _Table):
        self.tensors = [Tensor(x) for x in t.tables(0)]
        self.inputs = t.vector(1, "int32")
        self.outputs = t.vector(2, "int32")
        self.operators = [Operator(x) for x in t.tables(3)]
        self.name = t.string(4)


class Model:
    """The root table of a ``.tflite`` file."""

    def __init__(self, data: bytes):
        buf = memoryview(data)
        if len(buf) < 8:
            raise ValueError("tflite: file too short for a flatbuffer")
        root = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
        self.version = root.scalar(0, "uint32", 0)
        self.operator_codes = [OperatorCode(x) for x in root.tables(1)]
        self.subgraphs = [SubGraph(x) for x in root.tables(2)]
        self.description = root.string(3)
        # each buffer's bytes (None for an empty one)
        self.buffers: List[Optional[np.ndarray]] = []
        for b in root.tables(4):
            d = b.vector(0, "uint8")
            self.buffers.append(d if d.size else None)
