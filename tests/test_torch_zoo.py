"""The port's detection, pose and segmentation zoo (models/{ssd_mobilenet,
posenet,deeplab,convert}.py) against nnstreamer_tpu's on the CPU, on the
same weights (nnstreamer_tpu's flax parameters, carried by
models/convert.py), and the three zoo launch lines end to end against
nnstreamer_tpu's on the same frames.

Small sizes: 64×64 frames (plus 96 and a size 16 does not divide, 72),
batch 2. Tolerance, float32 on both sides (the same math in another
summation order, and XLA's exp and sigmoid against torch's, which differ
by an ulp): every output within 1e-5 absolute, and the output minus its
batch mean within 1% of that centred output's standard deviation, so a
model that ignored its input would not pass. ``make_anchors`` and the
decoded bytes of the lines are exact."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import deeplab as jdl
from nnstreamer_tpu.models import posenet as jpn
from nnstreamer_tpu.models import ssd_mobilenet as jssd
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import DataType, MessageType, TensorSpec, TensorsInfo
from nnstreamer_tpu_torch.models import deeplab as tdl
from nnstreamer_tpu_torch.models import posenet as tpn
from nnstreamer_tpu_torch.models import ssd_mobilenet as tssd
from nnstreamer_tpu_torch.models._blocks import make_u8_entry
from nnstreamer_tpu_torch.models.convert import (
    deeplab_params_from_flax,
    posenet_params_from_flax,
    ssd_params_from_flax,
)
from nnstreamer_tpu_torch.runtime.parse import parse_launch

ATOL = 1e-5
CENTRED_SHARE = 0.01
SIZE, BATCH = 64, 2
MODULE = __name__


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jssd64():
    fn, params, anchors = jssd.build_ssd_mobilenet(image_size=SIZE,
                                                   compute_dtype="float32")
    return fn, params, anchors, _tree(params)


@pytest.fixture(scope="module")
def jpose():
    fn, params = jpn.build_posenet(image_size=SIZE, compute_dtype="float32")
    return fn, params, _tree(params)


@pytest.fixture(scope="module")
def jseg():
    fn, params = jdl.build_deeplab(image_size=SIZE, compute_dtype="float32")
    return fn, params, _tree(params)


def _frames(seed, size=SIZE, n=BATCH):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _check(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, name
    err = np.abs(got - want).max()
    assert err <= ATOL, (name, err)

    def centred(a):
        return a - a.mean(axis=0, keepdims=True)

    cerr = np.abs(centred(got) - centred(want)).max()
    assert cerr <= CENTRED_SHARE * centred(want).std(), (name, cerr)


@pytest.mark.parametrize("size", [64, 96, 224])
def test_make_anchors_bit_equal(size):
    got = tssd.make_anchors(size, tssd.STRIDES)
    want = jssd.make_anchors(size, (8, 16, 32, 64))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if size == 224:
        assert got.shape == (3135, 4)


def test_decode_boxes_np_equal():
    rng = np.random.default_rng(1)
    anchors = tssd.make_anchors(SIZE, tssd.STRIDES)
    loc = rng.standard_normal((len(anchors), 4)).astype(np.float32)
    np.testing.assert_array_equal(tssd.decode_boxes_np(loc, anchors),
                                  jssd.decode_boxes_np(loc, anchors))


@pytest.mark.parametrize("name", ["ssd", "posenet", "deeplab"])
def test_converter_layout(name, jssd64, jpose, jseg):
    tree, convert, model = {
        "ssd": (jssd64[3], ssd_params_from_flax,
                tssd.SSDMobileNet(91, SIZE)),
        "posenet": (jpose[2], posenet_params_from_flax, tpn.PoseNet()),
        "deeplab": (jseg[2], deeplab_params_from_flax, tdl.DeepLab()),
    }[name]
    sd = convert(tree, "cpu")
    want = model.state_dict()
    assert sd.keys() == want.keys()
    assert all(sd[k].shape == want[k].shape for k in sd)
    leaves = jax.tree_util.tree_leaves(tree)
    assert sum(t.numel() for t in sd.values()) == sum(a.size for a in leaves)
    bf = convert(tree, "cpu", torch.bfloat16)
    assert {t.dtype for t in bf.values()} == {torch.bfloat16}
    extra = {"params": {**tree["params"], "Extra": {"kernel": np.zeros(1)}}}
    with pytest.raises(KeyError, match="leaves"):
        convert(extra, "cpu")


def test_ssd_head_layout(jssd64):
    """Conv_2i is the location head and Conv_2i+1 the class head of
    feature map i; a head's kernel (kh, kw, in, out) is (out, in, kh, kw)."""
    sd = ssd_params_from_flax(jssd64[3], "cpu")
    p = jssd64[3]["params"]
    for i in range(4):
        np.testing.assert_array_equal(
            sd[f"loc_heads.{i}.weight"].numpy(),
            p[f"Conv_{2 * i}"]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"conf_heads.{i}.bias"].numpy(),
                                      p[f"Conv_{2 * i + 1}"]["bias"])
    assert sd["conf_heads.0.weight"].shape == (3 * 91, 32, 3, 3)


def test_ssd_matches(jssd64):
    fn, params, anchors, tree = jssd64
    x = _frames(2)
    want_boxes, want_scores = fn(params, jnp.asarray(x))
    want_loc, want_conf = fn.raw(params, jnp.asarray(x))
    model = tssd.build_ssd_mobilenet(image_size=SIZE, compute_dtype="float32",
                                     device="cpu", params=tree)
    np.testing.assert_array_equal(model.anchors, anchors)
    with torch.inference_mode():
        boxes, scores = model(torch.from_numpy(x))
        loc, conf = model.raw(torch.from_numpy(x))
    n = len(anchors)
    assert boxes.shape == (BATCH, n, 4) and scores.shape == (BATCH, n, 91)
    _check(boxes, want_boxes, "boxes")
    _check(scores, want_scores, "scores")
    # the raw heads in nnstreamer_tpu's candidate order (cell-major,
    # aspect-minor within each stride)
    _check(loc, want_loc, "locations")
    _check(conf, want_conf, "logits")


def test_ssd_filter_model_raw(jssd64):
    fn, params, _, tree = jssd64
    x = _frames(3)
    want = fn.raw(params, jnp.asarray(x))
    entry = dataclasses.replace(tssd.filter_model_raw, image_size=SIZE,
                                compute_dtype="float32", params=tree)
    served = entry.make("cpu")
    got = served(torch.from_numpy(x))
    assert len(got) == 2
    for g, w, name in zip(got, want, ("locations", "logits")):
        _check(g, w, name)
    info = served.output_info(TensorsInfo.of(
        TensorSpec((BATCH, SIZE, SIZE, 3), DataType.UINT8)))
    assert [s.shape for s in info.specs] == [(BATCH, 255, 4), (BATCH, 255, 91)]
    with pytest.raises(ValueError, match="anchors are for 64x64"):
        served.output_info(TensorsInfo.of(
            TensorSpec((BATCH, 96, 96, 3), DataType.UINT8)))


def test_posenet_matches(jpose):
    fn, params, tree = jpose
    x = _frames(4)
    want = fn(params, jnp.asarray(x))
    want_kp = fn.keypoints(params, jnp.asarray(x))
    model = tpn.build_posenet(compute_dtype="float32", device="cpu",
                              params=tree)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        kp = model.keypoints(torch.from_numpy(x))
    assert got.shape == (BATCH, 8, 8, 17)
    _check(got, want, "heatmaps")
    _check(kp, want_kp, "keypoints")


@pytest.mark.parametrize("size", [64, 72])
def test_deeplab_matches(jseg, size):
    """72 is not a multiple of 16: the trunk's map is 5×5, upsampled ×14.4."""
    fn, params, tree = jseg
    x = _frames(5, size)
    want = fn(params, jnp.asarray(x))
    model = tdl.build_deeplab(compute_dtype="float32", device="cpu",
                              params=tree)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.shape == (BATCH, size, size, 21)
    _check(got, want, "logits")


@pytest.mark.parametrize("src,dst", [(14, 224), (5, 72), (4, 64), (7, 9)])
def test_bilinear_upsample_matches_jax_resize(src, dst):
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize(bilinear): half-pixel centres, clamped edges."""
    rng = np.random.default_rng(src * dst)
    x = rng.standard_normal((2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3),
                                       method="bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dilated_aspp_padding_matches(jseg):
    """The ASPP's dilated 3×3 convolutions (6 and 12) on a map smaller
    than their reach keep flax's SAME padding."""
    from nnstreamer_tpu.models._blocks import make_blocks
    from nnstreamer_tpu_torch.models._blocks import ConvBnRelu
    from nnstreamer_tpu_torch.models.convert import convbnrelu_params_from_flax

    JConv, _ = make_blocks("float32")
    rng = np.random.default_rng(6)
    for size, dil in ((4, 12), (5, 6), (14, 12), (3, 6)):
        x = rng.standard_normal((1, size, size, 8)).astype(np.float32)
        jm = JConv(6, (3, 3), dilation=dil)
        tree = jm.init(jax.random.key(dil), jnp.asarray(x))
        want = np.asarray(jm.apply(tree, jnp.asarray(x)))
        tm = ConvBnRelu(8, 6, (3, 3), dilation=dil)
        tm.load_state_dict(convbnrelu_params_from_flax(_tree(tree)["params"],
                                                       "cpu"))
        with torch.inference_mode():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("build", [
    lambda **k: tssd.build_ssd_mobilenet(image_size=SIZE, **k),
    tpn.build_posenet, tdl.build_deeplab], ids=["ssd", "posenet", "deeplab"])
def test_random_init_is_seeded(build):
    a = build(compute_dtype="float32", device="cpu", seed=3).state_dict()
    b = build(compute_dtype="float32", device="cpu", seed=3).state_dict()
    c = build(compute_dtype="float32", device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.weight"], c["stem.weight"])
    biases = [k for k in a if k.endswith(".bias") or k.endswith("bn_bias")]
    assert biases and not any(a[k].any() for k in biases)


def test_entries_build_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for entry in (tssd.filter_model_u8, tpn.filter_model_u8,
                  tdl.filter_model_u8):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry.make()


# ---------------------------------------------------------------------------
# the three launch lines end to end, on the same frames and weights

class _JaxU8:
    """nnstreamer_tpu's ``make_u8_entry`` over a given apply_fn and params
    (its own entries fix SSD at 224)."""

    def __init__(self, fn, params):
        self.fn, self.params = fn, params

    def make(self):
        return jax.jit(lambda x: self.fn(
            self.params, x.astype(jnp.float32) * (1.0 / 127.5) - 1.0))


LINE = ("tensor_src num-buffers={n} dimensions=3:{s}:{s}:1 types=uint8 "
        "pattern=random ! tensor_aggregator frames-out={b} frames-dim=0 "
        "concat=true ! queue max-size-buffers=4 ! tensor_filter {filt} "
        "name=f ! queue max-size-buffers=8 ! tensor_decoder {dec} "
        "frames-in={b} ! tensor_sink name=out max-stored=0")
DECODERS = {
    "ssd": ("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
            f"option3=,30 option4={SIZE}:{SIZE}"),
    "posenet": f"mode=pose_estimation option1={SIZE}:{SIZE} option2=heatmap",
    "deeplab": "mode=image_segment option1=tflite-deeplab",
}


@pytest.fixture(scope="module")
def entries(jssd64, jpose, jseg):
    port = {
        "ssd": dataclasses.replace(tssd.filter_model, image_size=SIZE,
                                   params=jssd64[3]),
        "posenet": dataclasses.replace(tpn.filter_model, params=jpose[2]),
        "deeplab": dataclasses.replace(tdl.filter_model, params=jseg[2]),
    }
    mod = sys.modules[MODULE]
    for name, entry in port.items():
        setattr(mod, f"PORT_{name.upper()}", make_u8_entry(entry))
    mod.JAX_SSD = _JaxU8(jssd64[0], jssd64[1])
    mod.JAX_POSENET = _JaxU8(jpose[0], jpose[1])
    mod.JAX_DEEPLAB = _JaxU8(jseg[0], jseg[1])
    return port


def _run_line(parse, filt, dec, n=4, b=BATCH):
    pipe = parse(LINE.format(n=n, s=SIZE, b=b, filt=filt, dec=dec))
    outs = []
    pipe.get("out").connect(outs.append)
    pipe.play()
    try:
        msg = pipe.wait(timeout=150)
    finally:
        pipe.stop()
    assert msg.type.value == "eos", msg
    return outs


def _decoded(buf):
    meta = {k: buf.meta[k] for k in ("detections", "keypoints", "class_map")
            if k in buf.meta}
    if "class_map" in meta:
        meta["class_map"] = np.asarray(meta["class_map"]).tolist()
    for key in ("detections", "keypoints"):
        if key in meta:
            meta[key] = [{k: v for k, v in d.items() if k != "score"}
                         for d in meta[key]]
    return bytes(np.ascontiguousarray(np.asarray(buf.tensors[0]))), meta


@pytest.mark.parametrize("name", ["ssd", "posenet", "deeplab"])
def test_zoo_line_matches_jax(name, entries):
    """tensor_src ! tensor_aggregator ! queue ! tensor_filter ! queue !
    tensor_decoder frames-in=2 ! tensor_sink, accelerator=cpu: one decoded
    buffer per frame, its bytes and its detections / keypoints / class map
    equal nnstreamer_tpu's (scores within 1e-5, below)."""
    dec = DECODERS[name]
    want = _run_line(jax_parse_launch,
                     f"framework=jax model={MODULE}:JAX_{name.upper()}", dec)
    got = _run_line(parse_launch, f"framework=torch accelerator=cpu "
                    f"model={MODULE}:PORT_{name.upper()}", dec)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _decoded(g) == _decoded(w)
    key = {"ssd": "detections", "posenet": "keypoints"}.get(name)
    if key:
        for g, w in zip(got, want):
            np.testing.assert_allclose([d["score"] for d in g.meta[key]],
                                       [d["score"] for d in w.meta[key]],
                                       rtol=0, atol=ATOL)
    if name == "ssd":
        assert any(g.meta["detections"] for g in got)


def test_zoo_line_filter_without_card_says_so(entries):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pipe = parse_launch(LINE.format(
        n=2, s=SIZE, b=BATCH, filt=f"framework=torch model={MODULE}:PORT_SSD",
        dec=DECODERS["ssd"]))
    pipe.play()
    try:
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type is MessageType.ERROR
    assert "accelerator=cpu" in msg.data["error"]
