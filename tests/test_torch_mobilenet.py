"""The port's MobileNet-v2 (models/{tflite_import,_blocks,mobilenet_v2,
convert}.py) against nnstreamer_tpu's on the CPU, on the same weights
(nnstreamer_tpu's flax parameters, carried by models/convert.py), and the
image-labeling launch lines end to end against nnstreamer_tpu's.

Tolerances, float32 on both sides (the same math in another summation
order): blocks within rtol 1e-5 / atol 1e-5 on outputs of order 1; the
full model within 1e-5 absolute on the logits, and within 1% of the
centred logits' standard deviation on the logits minus their batch mean —
with random weights the logits barely depend on the input (max |logit|
~0.03, centred std ~3e-4), so the first bound alone would pass a model
that ignored its input. Labels are exact."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import tflite_import as jtfl
from nnstreamer_tpu.models._blocks import make_blocks
from nnstreamer_tpu.models.mobilenet_v2 import build_mobilenet_v2 as jbuild
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.models import mobilenet_v2 as tmb
from nnstreamer_tpu_torch.models import tflite_import as ttfl
from nnstreamer_tpu_torch.models._blocks import (
    ConvBnRelu,
    InvertedResidual,
    make_u8_entry,
    resolve_compute_dtype,
)
from nnstreamer_tpu_torch.models.convert import (
    convbnrelu_params_from_flax,
    inverted_residual_params_from_flax,
    mobilenet_params_from_flax,
)
from nnstreamer_tpu_torch.runtime.parse import parse_launch

BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-5
LOGIT_ATOL = 1e-5
CENTRED_SHARE = 0.01
MODULE = __name__
# the port's filter_model_u8 carrying nnstreamer_tpu's seed-0 weights; set
# by the ``carried`` fixture, named by the launch lines as MODULE:CARRIED_U8
CARRIED_U8 = None


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _perturb_bn(tree, rng):
    """BN scale/bias away from flax's ones/zeros, so the blocks' scale and
    bias are exercised."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "bn_scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bn_bias":
                out[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


@pytest.fixture(scope="module")
def jax_model():
    """nnstreamer_tpu's float32 MobileNet-v2 (seed 0) and its numpy tree."""
    fn, params = jbuild(compute_dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jax.jit(fn), params, tree


@pytest.fixture(scope="module")
def carried(jax_model):
    entry = make_u8_entry(dataclasses.replace(tmb.filter_model,
                                              params=jax_model[2]))
    setattr(sys.modules[MODULE], "CARRIED_U8", entry)
    return entry


# (size, kernel, stride, dilation, padding); VALID only where the dilated
# kernel fits
PAD_CASES = [(n, k, s, d, p)
             for n in (1, 7, 8, 9, 112, 224) for k in (1, 3, 5)
             for s in (1, 2) for d in (1, 2) for p in ("SAME", "VALID")
             if p == "SAME" or (k - 1) * d + 1 <= n]


@pytest.mark.parametrize("case", PAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_explicit_padding_matches(case):
    size, k, stride, dilation, padding = case
    args = (size, size + 1, k, k, (stride, stride), (dilation, dilation),
            padding)
    assert ttfl.explicit_padding(*args) == jtfl.explicit_padding(*args)


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("stride,dilation,size", [(1, 1, 7), (2, 1, 8),
                                                  (2, 1, 9), (1, 2, 9)])
def test_depthwise_conv_matches_shift_add(mult, stride, dilation, size):
    """tflite's [1, kh, kw, C*mult] kernel is the port's (C*mult, 1, kh, kw)
    permuted; output channel o reads input channel o // mult."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((1, 3, 3, 4 * mult)).astype(np.float32)
    want = np.asarray(jtfl.depthwise_shift_add(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        (dilation, dilation)))
    got = _nhwc(ttfl.depthwise_conv(
        _nchw(x), torch.from_numpy(w).permute(3, 0, 1, 2).contiguous(),
        (stride, stride), "SAME", (dilation, dilation)))
    np.testing.assert_allclose(got, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)


# (in_ch, features, kernel, strides, groups, dilation, act, size)
CONV_CASES = [
    (3, 8, (3, 3), 2, 1, 1, True, 16),      # the stem: SAME at stride 2
    (3, 8, (3, 3), 2, 1, 1, True, 9),       # odd size: symmetric padding
    (4, 6, (3, 3), 1, 1, 1, True, 7),
    (8, 8, (3, 3), 2, 8, 1, True, 8),       # depthwise, stride 2
    (8, 8, (3, 3), 2, 8, 1, True, 7),
    (8, 8, (3, 3), 1, 8, 1, True, 9),       # depthwise, stride 1
    (8, 8, (3, 3), 1, 8, 2, True, 9),       # depthwise, dilation 2
    (4, 8, (3, 3), 1, 4, 1, True, 6),       # depthwise, multiplier 2
    (4, 8, (3, 3), 1, 2, 1, True, 6),       # grouped, not depthwise
    (16, 12, (1, 1), 1, 1, 1, False, 5),    # 1x1 projection, no relu6
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_convbnrelu_matches(case):
    in_ch, feat, kernel, strides, groups, dil, act, size = case
    JConv, _ = make_blocks("float32")
    jm = JConv(feat, kernel, strides=strides, groups=groups, dilation=dil,
               act=act)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, size, size, in_ch)).astype(np.float32) * 3
    tree = _perturb_bn(jm.init(jax.random.key(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    tm = ConvBnRelu(in_ch, feat, kernel, strides, groups, dil, act)
    tm.load_state_dict(convbnrelu_params_from_flax(tree["params"], "cpu"))
    with torch.inference_mode():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)


# (in_ch, features, strides, expand, size)
IR_CASES = [
    (8, 8, 1, 6, 9),      # residual
    (8, 8, 1, 1, 8),      # residual, no expansion
    (8, 16, 2, 6, 8),     # stride 2: no residual
    (8, 12, 1, 6, 7),     # widths differ: no residual
    (16, 8, 1, 1, 6),     # no expansion, no residual
]


@pytest.mark.parametrize("case", IR_CASES, ids=lambda c: "-".join(map(str, c)))
def test_inverted_residual_matches(case):
    in_ch, feat, strides, expand, size = case
    _, JIR = make_blocks("float32")
    jm = JIR(feat, strides, expand)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, size, size, in_ch)).astype(np.float32)
    tree = _perturb_bn(jm.init(jax.random.key(0), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    tm = InvertedResidual(in_ch, feat, strides, expand)
    assert tm.residual == (strides == 1 and in_ch == feat)
    tm.load_state_dict(inverted_residual_params_from_flax(tree["params"], "cpu"))
    with torch.inference_mode():
        got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)


def _check_logits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= LOGIT_ATOL

    def centred(a):
        return a - a.mean(axis=0, keepdims=True)

    err = np.abs(centred(got) - centred(want)).max()
    assert err <= CENTRED_SHARE * centred(want).std(), err
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_converter_layout(jax_model):
    _, _, tree = jax_model
    sd = mobilenet_params_from_flax(tree, "cpu")
    assert len(sd) == 158
    assert sum(t.numel() for t in sd.values()) == 3_506_153
    p = tree["params"]
    np.testing.assert_array_equal(
        sd["stem.weight"].numpy(),
        p["ConvBnRelu_0"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    dw = p["InvertedResidual_1"]["ConvBnRelu_1"]["depthwise_kernel"]
    assert dw.shape == (3, 3, 1, 96)
    np.testing.assert_array_equal(sd["blocks.1.dw.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["fc.weight"].numpy(),
                                  p["Dense_0"]["kernel"].T)
    assert sd["blocks.0.dw.weight"].shape == (32, 1, 3, 3)   # no expansion
    assert "blocks.0.expand.weight" not in sd
    bf = mobilenet_params_from_flax(tree, "cpu", torch.bfloat16)
    assert {t.dtype for t in bf.values()} == {torch.bfloat16}
    extra = {"params": {**p, "Extra": {"kernel": np.zeros(1)}}}
    with pytest.raises(KeyError, match="leaves"):
        mobilenet_params_from_flax(extra, "cpu")


def test_full_model_matches(jax_model):
    """224×224, width 1.0, 1001 classes, batch 2, float32."""
    fn, params, tree = jax_model
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(fn(params, x))
    model = tmb.build_mobilenet_v2(compute_dtype="float32", device="cpu",
                                   params=tree)
    assert sum(p.numel() for p in model.parameters()) == 3_506_153
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    _check_logits(got, want)


def test_filter_model_u8_matches(jax_model, carried):
    from nnstreamer_tpu.models.mobilenet_v2 import filter_model_u8 as jentry

    rng = np.random.default_rng(6)
    x = rng.integers(0, 127, (3, 224, 224, 3)).astype(np.uint8)
    want = np.asarray(jentry.make()(jnp.asarray(x)))
    served = carried.make("cpu")
    got = served(torch.from_numpy(x)).numpy()
    _check_logits(got, want)
    from nnstreamer_tpu_torch.core import DataType, TensorSpec, TensorsInfo
    info = served.output_info(TensorsInfo.of(
        TensorSpec((3, 224, 224, 3), DataType.UINT8)))
    assert info.specs[0].shape == (3, 1001)
    assert info.specs[0].dtype is DataType.FLOAT32


def test_random_init_is_seeded_lecun(jax_model):
    """The port's own init: the same weights for a seed on every device,
    flax's distributions (lecun_normal: variance 1/fan_in, truncated at
    ±2 std; BN scale ones, biases zeros)."""
    a = tmb.build_mobilenet_v2(compute_dtype="float32", device="cpu", seed=3)
    b = tmb.build_mobilenet_v2(compute_dtype="float32", device="cpu", seed=3)
    c = tmb.build_mobilenet_v2(compute_dtype="float32", device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["stem.weight"], sc["stem.weight"])
    for name, fan_in in (("head.weight", 320), ("blocks.5.dw.weight", 9),
                         ("fc.weight", 1280)):
        w = sa[name].double()
        std = (1.0 / fan_in) ** 0.5
        assert abs(w.var().item() * fan_in - 1.0) < 0.15, name
        assert w.abs().max().item() <= 2 * std / .87962566103423978 + 1e-6
    assert torch.equal(sa["blocks.3.project.bn_scale"],
                       torch.ones_like(sa["blocks.3.project.bn_scale"]))
    assert not sa["fc.bias"].any() and not sa["blocks.3.dw.bn_bias"].any()


def test_resolve_compute_dtype():
    assert resolve_compute_dtype("auto", "cpu") is torch.float32
    assert resolve_compute_dtype("bfloat16", "cpu") is torch.bfloat16
    assert resolve_compute_dtype(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_compute_dtype("float16", "cpu")


HEAD = ("tensor_src num-buffers=8 dimensions=3:224:224:1 types=uint8 "
        "pattern=random ! tensor_aggregator frames-out=4 frames-dim=0 "
        "concat=true ! queue max-size-buffers=4 ! tensor_filter {filt} "
        "sync-invoke=false name=f")
JAX_FILTER = "framework=jax model=nnstreamer_tpu.models.mobilenet_v2:filter_model_u8"
PORT_FILTER = f"framework=torch model={MODULE}:CARRIED_U8 accelerator=cpu"


def _run(parse, line: str):
    pipe = parse(line)
    outs = []
    pipe.get("out").connect(lambda b: outs.append(b))
    pipe.play()
    try:
        msg = pipe.wait(timeout=150)
        caps = pipe.get("out").sinkpad.caps
    finally:
        pipe.stop()
    assert msg.type.value == "eos", msg
    return outs, caps


def test_bench_line_matches_jax(carried):
    tail = " ! queue max-size-buffers=4 ! tensor_sink name=out max-stored=1"
    want, _ = _run(jax_parse_launch, HEAD.format(filt=JAX_FILTER) + tail)
    got, caps = _run(parse_launch, HEAD.format(filt=PORT_FILTER) + tail)
    assert str(caps) == ("other/tensors,format=static,num_tensors=1,"
                         "dimensions=1001:4,types=float32")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        t = g.tensors[0]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        _check_logits(t.numpy(), np.asarray(w.tensors[0]))
    # the frames are the host tensor_src's seed-0 frames, so the labels are
    # the argmax of the model on those frames
    rng = np.random.default_rng(0)
    frames = np.concatenate([rng.integers(0, 127, (1, 224, 224, 3))
                             .astype(np.uint8) for _ in range(8)])
    logits = carried.make("cpu")(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(
        np.concatenate([g.tensors[0].numpy() for g in got]).argmax(-1),
        logits.argmax(-1))


def test_labeling_line_matches_jax(carried, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"class{i}\n" for i in range(1001)))
    tail = (f" ! tensor_decoder mode=image_labeling option1={labels} "
            "frames-in=4 ! tensor_sink name=out max-stored=1")
    want, _ = _run(jax_parse_launch, HEAD.format(filt=JAX_FILTER) + tail)
    got, caps = _run(parse_launch, HEAD.format(filt=PORT_FILTER) + tail)
    assert str(caps) == "text/plain"
    assert len(got) == len(want) == 8            # one label buffer per frame
    for g, w in zip(got, want):
        assert g.meta["label_indices"] == w.meta["label_indices"]
        assert g.meta["labels"] == w.meta["labels"]
        assert len(g.meta["labels"]) == 1
        assert bytes(g.tensors[0]) == bytes(np.asarray(w.tensors[0]))
    assert [g.offset for g in got] == [w.offset for w in want]
    assert got[0].meta["label"] == f"class{got[0].meta['label_index']}"


def test_filter_without_card_says_so(carried):
    """Without accelerator=cpu the filter asks for the card: on a machine
    without one it posts an error naming the CPU option, and never runs on
    the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pipe = parse_launch(HEAD.format(
        filt=f"framework=torch model={MODULE}:CARRIED_U8")
        + " ! tensor_sink name=out")
    pipe.play()
    try:
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type is MessageType.ERROR
    assert "accelerator=cpu" in msg.data["error"]
