"""The port's ``.tflite`` importer (``models/tflite_import.py`` with its
fake-quant and float executor, ``tflite_int8.py`` and
``tflite_q8_native.py``) against nnstreamer_tpu's on the same files and
frames (numpy seeds). The reference runs as its own tests run it on the
CPU (its executors are plain XLA, no Pallas kernel).

* tiny per-channel fixture: all four modes byte-exact;
* full-width MobileNet-v2 int8 fixture on 4 frames: int8 and int8-native
  byte-exact, float within 2 LSB. fake-quant is not within 2 LSB (6 on
  these frames): the first conv now sums in XLA's order
  (``test_torch_tflite_fma.py``), but later layers' float32 sums differ
  from XLA's in the last bit and the snapping turns that into whole steps
  that grow layer by layer (ROADMAP §C); the first layer is held to that;
* graphs the TF converter makes here: float outputs within 1e-5 of the
  reference run eagerly, as its own tests run them;
* ``batch:N`` equals the stacked per-frame outputs;
* bad options and int8 on a float graph raise the reference's texts."""
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
import jax  # noqa: E402

import nnstreamer_tpu.models.tflite_import as R  # noqa: E402
import nnstreamer_tpu_torch.models.tflite_import as P  # noqa: E402
from nnstreamer_tpu_torch.native import q8  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TINY = str(FIXTURES / "tiny_int8_perchannel.tflite")
MODEL = str(FIXTURES / "mobilenet_v2_1.0_224_int8.tflite")
MODES = ["fake-quant", "int8", "float", "int8-native"]
needs_q8 = pytest.mark.skipif(not q8.available(),
                              reason="native q8 engine not buildable here")


def _sig(info):
    return [(tuple(s.shape), s.dtype.value) for s in info.specs]


def _ref(fn, mode, *xs):
    if mode == "int8-native":
        return [np.asarray(o) for o in fn(*xs)]
    return [np.asarray(o) for o in jax.jit(fn)(*xs)]


def _port(fn, *xs):
    out = fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in xs))
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in out]


def _lsb(a, b) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


@pytest.mark.parametrize("mode", MODES)
def test_tiny_fixture_all_modes_byte_exact(mode):
    if mode == "int8-native" and not q8.available():
        pytest.skip("native q8 engine not buildable here")
    rng = np.random.default_rng(3)
    xs = [rng.integers(-128, 127, (1, 16, 16, 3)).astype(np.int8)
          for _ in range(4)]
    rfn, rin, rout = R.load_tflite(TINY, {"quantized_exec": mode})
    pfn, pin, pout = P.load_tflite(TINY, {"quantized_exec": mode},
                                   device="cpu")
    assert _sig(pin) == _sig(rin) and _sig(pout) == _sig(rout)
    for x in xs:
        want, got = _ref(rfn, mode, x)[0], _port(pfn, x)[0]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return rng.integers(-128, 128, (4, 224, 224, 3)).astype(np.int8)


@pytest.fixture(scope="module")
def full_width(frames):
    """One batch-4 load per mode and package, each run once on frames."""
    cache = {}

    def get(mode):
        if mode not in cache:
            opts = {"quantized_exec": mode, "batch": "4"}
            rfn, _, rout = R.load_tflite(MODEL, opts)
            pfn, _, pout = P.load_tflite(MODEL, opts, device="cpu")
            assert _sig(pout) == _sig(rout) == [((4, 1001), "int8")]
            cache[mode] = (_ref(rfn, mode, frames)[0], _port(pfn, frames)[0])
        return cache[mode]
    return get


@pytest.mark.parametrize("mode", ["int8", pytest.param(
    "int8-native", marks=needs_q8)])
def test_full_width_integer_modes_byte_exact(full_width, mode):
    want, got = full_width(mode)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[0])) >= 100  # the fixture has not collapsed


def test_full_width_float_within_2_lsb(full_width):
    want, got = full_width("float")
    assert _lsb(got, want) <= 2


def test_full_width_fake_quant_first_layer(frames):
    """The first conv sees the same input in both packages; its float32
    sums differ from XLA's only in rounding, and a snapped byte differs
    only where the reference's value lies at a rounding boundary."""
    rec = {"r": [], "p": []}
    rfn, _, _ = R.load_tflite(MODEL, {"batch": "4"})
    pfn, _, _ = P.load_tflite(MODEL, {"batch": "4"}, device="cpu")
    steps, tensors, *_ = P.read_model(MODEL)
    t = tensors[steps[0][3][0]]
    scale, zp = float(t.scale[0]), float(t.zero_point[0])
    orig_r, orig_p = R._fused, P._fused

    def first(store, orig, to_np):
        def fused(act, y):
            if not store:
                store.append(to_np(y))
            return orig(act, y)
        return fused
    try:
        R._fused = first(rec["r"], orig_r, np.asarray)
        P._fused = first(rec["p"], orig_p, lambda y: y.numpy().copy())
        rfn(frames[:1])
        pfn(torch.from_numpy(frames))
    finally:
        R._fused, P._fused = orig_r, orig_p
    yr, yp = rec["r"][0], rec["p"][0][:1]
    assert steps[0][0] == "CONV_2D" and yr.shape == yp.shape
    assert np.abs(yr - yp).max() <= 1e-6 * np.abs(yr).max()
    qr, qp = np.round(yr / scale) + zp, np.round(yp / scale) + zp
    off = np.abs(qr - qp)
    assert off.max() <= 1
    frac = np.abs(np.abs(yr / scale - np.floor(yr / scale)) - 0.5)
    assert np.all(frac[off > 0] < 1e-3)


def test_batch_equals_stacked_per_frame(frames):
    f4, in4, out4 = P.load_tflite(MODEL, {"quantized_exec": "int8",
                                          "batch": "4"}, device="cpu")
    f1, in1, _ = P.load_tflite(MODEL, {"quantized_exec": "int8"},
                               device="cpu")
    assert _sig(in4) == [((4, 224, 224, 3), "int8")]
    assert _sig(in1) == [((1, 224, 224, 3), "int8")]
    assert _sig(out4) == [((4, 1001), "int8")]
    want = np.concatenate([_port(f1, frames[i:i + 1])[0] for i in range(4)])
    np.testing.assert_array_equal(_port(f4, frames)[0], want)
    rng = np.random.default_rng(5)
    xs = rng.integers(-128, 127, (3, 16, 16, 3)).astype(np.int8)
    tb = P.load_tflite(TINY, {"batch": "3"}, device="cpu")[0]
    t1 = P.load_tflite(TINY, {}, device="cpu")[0]
    np.testing.assert_array_equal(
        _port(tb, xs)[0],
        np.concatenate([_port(t1, xs[i:i + 1])[0] for i in range(3)]))


def _convert_fn(tmp_path, name, fn, *specs):
    cf = tf.function(fn).get_concrete_function(
        *(tf.TensorSpec(s, tf.float32) for s in specs))
    path = tmp_path / f"{name}.tflite"
    path.write_bytes(
        tf.lite.TFLiteConverter.from_concrete_functions([cf]).convert())
    return str(path)


def _dense_pool_pad_softmax(tmp_path):
    inp = tf.keras.Input((8, 8, 3))
    x = tf.keras.layers.ZeroPadding2D(1)(inp)
    x = tf.keras.layers.MaxPool2D(2)(x)
    x = tf.keras.layers.AveragePooling2D(2, strides=1, padding="same")(x)
    x = tf.keras.layers.Conv2D(4, 3, padding="same", activation="relu6")(x)
    x = tf.keras.layers.DepthwiseConv2D(3, depth_multiplier=2,
                                        padding="same")(x)
    x = tf.keras.layers.GlobalAveragePooling2D()(x)  # MEAN
    x = tf.keras.layers.Dense(10)(x)                 # FULLY_CONNECTED
    out = tf.keras.layers.Softmax()(x)
    path = tmp_path / "synth.tflite"
    path.write_bytes(tf.lite.TFLiteConverter.from_keras_model(
        tf.keras.Model(inp, out)).convert())
    rng = np.random.default_rng(0)
    return str(path), [rng.random((1, 8, 8, 3)).astype(np.float32)]


def _postprocess(tmp_path):
    def post(boxes, scores):
        cy = tf.strided_slice(boxes, [0, 0, 0], [0, 0, 1], [1, 1, 1],
                              begin_mask=3, end_mask=3, shrink_axis_mask=4)
        ch = tf.strided_slice(boxes, [0, 0, 2], [0, 0, 3], [1, 1, 1],
                              begin_mask=3, end_mask=3, shrink_axis_mask=4)
        size = tf.exp(ch) * 2.0
        corners = tf.stack([cy - size / 2.0, cy + size / 2.0], axis=-1)
        a, b = tf.split(scores, 2, axis=-1)
        m = tf.maximum(a, b)
        bestf = tf.cast(tf.argmax(m, axis=-1), tf.float32)
        tot = tf.reduce_sum(m, axis=-1) + tf.reduce_max(m, axis=-1)
        return corners, bestf, tot

    rng = np.random.default_rng(0)
    return (_convert_fn(tmp_path, "postproc", post, (1, 32, 4), (1, 32, 6)),
            [rng.standard_normal((1, 32, 4)).astype(np.float32),
             rng.standard_normal((1, 32, 6)).astype(np.float32)])


def _upsampling_decoder(tmp_path):
    rng = np.random.default_rng(1)
    w_up = tf.constant(rng.standard_normal((2, 2, 4, 8)) * 0.1, tf.float32)

    def dec(x):
        up = tf.nn.conv2d_transpose(x, w_up, output_shape=[1, 16, 16, 4],
                                    strides=[1, 2, 2, 1], padding="SAME")
        up = tf.nn.leaky_relu(up, alpha=0.1)
        hs = up * tf.nn.relu6(up + 3.0) / 6.0
        nn = tf.compat.v1.image.resize_nearest_neighbor(hs, [32, 32])
        d2s = tf.nn.depth_to_space(nn, 2)
        y = tf.stack(tf.unstack(d2s, axis=-1), axis=-1)
        bil = tf.compat.v1.image.resize_bilinear(y, [20, 20],
                                                 half_pixel_centers=True)
        return bil * tf.math.rsqrt(
            tf.reduce_sum(bil * bil, axis=-1, keepdims=True) + 1e-6)

    return (_convert_fn(tmp_path, "decoder", dec, (1, 8, 8, 8)),
            [rng.standard_normal((1, 8, 8, 8)).astype(np.float32)])


def _corners(tmp_path):
    rng = np.random.default_rng(7)
    w = tf.constant(rng.standard_normal((2, 2, 6, 6)) * 0.3, tf.float32)

    def net(x, idxf):
        up = tf.nn.relu(tf.nn.conv2d_transpose(
            x, w, output_shape=[2, 6, 6, 6], strides=[1, 2, 2, 1],
            padding="SAME"))
        nn = tf.compat.v1.image.resize_nearest_neighbor(
            up[:, :3, :3, :], [5, 5], align_corners=True)
        a, b2, c = tf.split(up, [2, -1, 1], axis=-1)
        g = tf.gather(tf.reshape(up, [2, 36, 6]), tf.cast(idxf, tf.int32),
                      axis=1, batch_dims=1)
        return nn, a + b2[..., :2] + c, g

    return (_convert_fn(tmp_path, "corners", net, (2, 3, 3, 6), (2, 4)),
            [rng.standard_normal((2, 3, 3, 6)).astype(np.float32),
             rng.integers(0, 36, (2, 4)).astype(np.float32)])


@pytest.mark.parametrize("make", [_dense_pool_pad_softmax, _postprocess,
                                  _upsampling_decoder, _corners],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_synthesized_graph_matches_reference(tmp_path, make):
    path, xs = make(tmp_path)
    rfn, rin, rout = R.load_tflite(path)
    pfn, pin, pout = P.load_tflite(path, device="cpu")
    assert _sig(pin) == _sig(rin) and _sig(pout) == _sig(rout)
    # eagerly, as the reference's own tests run these graphs (jit lets XLA
    # contract and reassociate; its bilinear resize then moves by ulps,
    # which the decoder's near-zero normalization amplifies)
    want, got = [np.asarray(o) for o in rfn(*xs)], _port(pfn, *xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g.astype(np.float32) - w.astype(np.float32)
                      ).max() <= 1e-5


@pytest.fixture(scope="module")
def float_graph(tmp_path_factory):
    def affine(x):
        return tf.reshape(x * 3.0 + 1.0, [-1])
    return _convert_fn(tmp_path_factory.mktemp("g"), "affine", affine,
                       (1, 4))


@pytest.mark.parametrize("opts", [
    {"precision": "turbo"}, {"quantized_exec": "fp4"}, {"batch": "x"},
    {"batch": "0"}, {"quantized_exec": "int8"}, {"batch": "2"},
    {"quantized_exec": "int8_native"}],
    ids=["precision", "quantized_exec", "batch_text", "batch_zero",
         "int8_float_graph", "not_batch_polymorphic", "native_float_graph"])
def test_bad_options_raise_reference_texts(float_graph, opts):
    with pytest.raises(ValueError) as want:
        R.load_tflite(float_graph, opts)
    with pytest.raises(ValueError) as got:
        P.load_tflite(float_graph, opts, device="cpu")
    # the reference's text up to where it quotes its tracer's own message
    assert str(got.value).split(" (shape tracing")[0] == \
        str(want.value).split(" (shape tracing")[0]


def test_precisions_run_and_agree(float_graph):
    x = np.arange(4, dtype=np.float32).reshape(1, 4)
    outs = [_port(P.load_tflite(float_graph, {"precision": p},
                                device="cpu")[0], x)[0]
            for p in ("highest", "high", "default")]
    np.testing.assert_array_equal(outs[0], x.reshape(-1) * 3 + 1)
    np.testing.assert_allclose(outs[2], outs[0], rtol=1e-2)


def test_rounding_at_exact_halves_matches_reference():
    """Both executors round half to even (fake-quant snapping, requantize,
    output quantization) as jnp.round and the q8 engine's lrintf do; the
    quotient by a scale is the true float32 quotient."""
    import jax.numpy as jnp

    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, 127.5],
                      np.float32)
    np.testing.assert_array_equal(
        torch.round(torch.from_numpy(halves)).numpy(),
        np.asarray(jnp.round(halves)))
    sc = P.ScalarCache(torch.device("cpu"))
    y = np.array([0.125, 0.375, -0.625, 1.1], np.float32)
    np.testing.assert_array_equal(
        (torch.from_numpy(y) / sc(0.25)).numpy(), y / np.float32(0.25))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.load_tflite(TINY)


def test_callables_are_capture_safe_with_shape_rule():
    from nnstreamer_tpu_torch.core import DataType, TensorsInfo
    from nnstreamer_tpu_torch.core.tensors import TensorSpec

    for mode in ("fake-quant", "float", "int8"):
        fn, _, _ = P.load_tflite(TINY, {"quantized_exec": mode},
                                 device="cpu")
        assert fn.capture_safe
        info = fn.output_info(TensorsInfo.of(
            TensorSpec((5, 16, 16, 3), DataType.INT8)))
        assert _sig(info) == [((5, 10), "int8")]


def test_torch_backend_serves_tflite_like_the_jax_backend():
    from nnstreamer_tpu.backends.base import FilterProperties as RProps
    from nnstreamer_tpu.backends.jax_backend import JaxBackend
    from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                    FilterProperties)
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
    from nnstreamer_tpu_torch.core import DataType, TensorsInfo
    from nnstreamer_tpu_torch.core.tensors import TensorSpec

    x = np.random.default_rng(2).integers(-128, 128, (1, 16, 16, 3)
                                          ).astype(np.int8)
    for mode in MODES:
        if mode == "int8-native" and not q8.available():
            continue
        be = TorchBackend()
        be.open(FilterProperties(model=TINY, custom=f"quantized_exec:{mode}",
                                 accelerator=Accelerator.CPU))
        ref = JaxBackend()
        ref.open(RProps(model=TINY, custom=f"quantized_exec:{mode}"))
        try:
            got = be.invoke([x])[0]
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(ref.invoke([x])[0]))
            assert [_sig(i) for i in be.get_model_info()] == \
                [_sig(i) for i in ref.get_model_info()]
            other = TensorsInfo.of(TensorSpec((2, 16, 16, 3), DataType.INT8))
            if mode == "int8-native":
                assert be.fusion_callable() is None
                with pytest.raises(ValueError, match="fixed at load"):
                    be.set_input_info(other)
            else:
                assert be.fusion_callable() is not None
                assert _sig(be.set_input_info(other)) == [((2, 10), "int8")]
        finally:
            be.close()
            ref.close()


def test_pipeline_line_runs_all_modes_on_cpu():
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    for mode in MODES:
        if mode == "int8-native" and not q8.available():
            continue
        pipe = parse_launch(
            "tensor_src num-buffers=4 dimensions=3:16:16:1 types=int8 "
            "pattern=random ! tensor_aggregator frames-out=2 frames-dim=0 "
            "concat=true ! tensor_filter framework=torch accelerator=cpu "
            f"model={TINY} custom=quantized_exec:{mode},batch:2 ! "
            "tensor_decoder mode=image_labeling frames-in=2 ! tensor_sink "
            "name=out")
        labels = []
        pipe.get("out").connect(lambda b: labels.append(b.meta["label_index"]))
        pipe.play()
        try:
            msg = pipe.wait(timeout=60)
        finally:
            pipe.stop()
        assert msg.type.name == "EOS" and len(labels) == 4, (mode, msg)
