"""The port's own reader of the ``.tflite`` flatbuffer
(``models/tflite_schema.py``) against TensorFlow's generated schema
bindings: every field the reader returns equals the bindings' value, on
both committed fixtures and on graphs the TF converter makes here. The
port never imports TensorFlow; this test uses it as the oracle."""
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
from tensorflow.lite.python import schema_py_generated as s  # noqa: E402

from nnstreamer_tpu_torch.models import tflite_schema as ts  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _camel(field: str) -> str:
    return "".join(w.capitalize() for w in field.split("_"))


def _same_vec(mine: np.ndarray, theirs_fn, length: int):
    if not length:
        assert mine.size == 0
    else:
        np.testing.assert_array_equal(mine, theirs_fn())
        assert mine.dtype == theirs_fn().dtype


def _compare(data: bytes) -> int:
    """Assert every field equal; return the number of operators seen."""
    m = ts.Model(data)
    r = s.Model.GetRootAsModel(data, 0)
    assert m.version == r.Version()
    assert m.description == (r.Description().decode()
                             if r.Description() else None)
    assert len(m.buffers) == r.BuffersLength()
    for i, b in enumerate(m.buffers):
        rb = r.Buffers(i)
        if rb.DataLength():
            np.testing.assert_array_equal(b, rb.DataAsNumpy())
        else:
            assert b is None
    assert len(m.operator_codes) == r.OperatorCodesLength()
    for i, oc in enumerate(m.operator_codes):
        roc = r.OperatorCodes(i)
        assert (oc.builtin_code, oc.deprecated_builtin_code, oc.version) == (
            roc.BuiltinCode(), roc.DeprecatedBuiltinCode(), roc.Version())
        assert oc.custom_code == (roc.CustomCode().decode()
                                  if roc.CustomCode() else None)
        assert oc.code == max(roc.BuiltinCode(), roc.DeprecatedBuiltinCode())
    by_type = {tid: name for name, (tid, _) in ts.OPTIONS.items()}
    n_ops = 0
    assert len(m.subgraphs) == r.SubgraphsLength()
    for gi, sg in enumerate(m.subgraphs):
        rs = r.Subgraphs(gi)
        assert sg.name == (rs.Name().decode() if rs.Name() else None)
        _same_vec(sg.inputs, rs.InputsAsNumpy, rs.InputsLength())
        _same_vec(sg.outputs, rs.OutputsAsNumpy, rs.OutputsLength())
        assert len(sg.tensors) == rs.TensorsLength()
        for ti, t in enumerate(sg.tensors):
            rt = rs.Tensors(ti)
            _same_vec(t.shape, rt.ShapeAsNumpy, rt.ShapeLength())
            assert (t.type, t.buffer) == (rt.Type(), rt.Buffer())
            assert t.name == (rt.Name().decode() if rt.Name() else None)
            q, rq = t.quantization, rt.Quantization()
            assert (q is None) == (rq is None)
            if q is not None:
                _same_vec(q.scale, rq.ScaleAsNumpy, rq.ScaleLength())
                _same_vec(q.zero_point, rq.ZeroPointAsNumpy,
                          rq.ZeroPointLength())
                assert q.quantized_dimension == rq.QuantizedDimension()
        assert len(sg.operators) == rs.OperatorsLength()
        for oi, op in enumerate(sg.operators):
            rop = rs.Operators(oi)
            n_ops += 1
            assert op.opcode_index == rop.OpcodeIndex()
            _same_vec(op.inputs, rop.InputsAsNumpy, rop.InputsLength())
            _same_vec(op.outputs, rop.OutputsAsNumpy, rop.OutputsLength())
            assert op.builtin_options_type == rop.BuiltinOptionsType()
            name = by_type.get(rop.BuiltinOptionsType())
            if rop.BuiltinOptions() is None:
                assert op.options(name or "AddOptions") is None
                continue
            if name is None:
                continue
            typed = getattr(s, name)()
            raw = rop.BuiltinOptions()
            typed.Init(raw.Bytes, raw.Pos)
            for field, value in op.options(name).items():
                if isinstance(value, np.ndarray):
                    cam = _camel(field)
                    _same_vec(value, getattr(typed, cam + "AsNumpy"),
                              getattr(typed, cam + "Length")())
                else:
                    assert value == getattr(typed, _camel(field))(), field
    return n_ops


def test_builtin_operator_table_is_the_schema_enum():
    theirs = {v: k for k, v in vars(s.BuiltinOperator).items()
              if not k.startswith("_")}
    assert len(ts.BUILTIN_OPERATORS) == len(theirs)
    for code, name in theirs.items():
        assert ts.builtin_name(code) == name
    # an unknown code keeps the reference's str(code) name
    assert ts.builtin_name(len(theirs) + 7) == str(len(theirs) + 7)
    assert ts.builtin_name(-1) == "-1"


def test_options_union_ids_are_the_schema_enum():
    for name, (tid, fields) in ts.OPTIONS.items():
        assert getattr(s.BuiltinOptions, name) == tid
        cls = getattr(s, name)
        for field in fields:
            assert hasattr(cls, _camel(field)), (name, field)


@pytest.mark.parametrize("name", ["tiny_int8_perchannel.tflite",
                                  "mobilenet_v2_1.0_224_int8.tflite"])
def test_fixture_fields_equal_bindings(name):
    assert _compare((FIXTURES / name).read_bytes()) > 0


def _keras_dense_pool_pad_softmax():
    inp = tf.keras.Input((8, 8, 3))
    x = tf.keras.layers.ZeroPadding2D(1)(inp)
    x = tf.keras.layers.MaxPool2D(2)(x)
    x = tf.keras.layers.AveragePooling2D(2, padding="same")(x)
    x = tf.keras.layers.Conv2D(4, 3, dilation_rate=2, padding="same")(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)
    x = tf.keras.layers.Dense(10)(x)
    out = tf.keras.layers.Softmax()(x)
    return tf.lite.TFLiteConverter.from_keras_model(
        tf.keras.Model(inp, out)).convert()


def _fn_graph():
    def post(boxes, scores):
        cy = tf.strided_slice(boxes, [0, 0, 0], [0, 0, 1], [1, 1, 1],
                              begin_mask=3, end_mask=3, shrink_axis_mask=4)
        a, b = tf.split(scores, 2, axis=-1)
        m = tf.maximum(a, b)
        up = tf.compat.v1.image.resize_nearest_neighbor(
            tf.reshape(m, [1, 4, 8, 3]), [8, 16], half_pixel_centers=True)
        bil = tf.compat.v1.image.resize_bilinear(up, [16, 16],
                                                 align_corners=True)
        return (tf.stack([cy, cy * 2.0], axis=-1),
                tf.reduce_sum(m, axis=-1, keepdims=True),
                tf.nn.depth_to_space(tf.concat([bil, bil[..., :1]], -1), 2), tf.nn.leaky_relu(m, 0.3),
                tf.squeeze(tf.expand_dims(m, 0), [0]))

    cf = tf.function(post).get_concrete_function(
        tf.TensorSpec((1, 32, 4), tf.float32),
        tf.TensorSpec((1, 32, 6), tf.float32))
    return tf.lite.TFLiteConverter.from_concrete_functions([cf]).convert()


@pytest.mark.parametrize("make", [_keras_dense_pool_pad_softmax, _fn_graph],
                         ids=["keras_dense_pool_pad_softmax", "fn_graph"])
def test_synthesized_graph_fields_equal_bindings(make):
    assert _compare(make()) > 3


def test_short_file_is_refused():
    with pytest.raises(ValueError, match="too short"):
        ts.Model(b"TFL3")
