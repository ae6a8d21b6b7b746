"""The port's transformer, cached decoding and serving entries against
nnstreamer_tpu's, on the same weights (carried by models/convert.py) at the
``tiny`` config. Float results agree within f32 tolerance (rtol 1e-4, atol
1e-5: the same math in another summation order); greedy tokens agree
exactly."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decoding as jdec
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.models import decoding as tdec
from nnstreamer_tpu_torch.models import lm_serving as tlm
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.models.convert import params_from_jax

TINY = dict(vocab=64, dim=32, heads=4, layers=2, max_seq=64)
RTOL, ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def weights():
    """nnstreamer_tpu's tiny parameters (seed 0) as numpy, and the port's."""
    tree = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jtr.TransformerConfig(**TINY), seed=0))
    return tree, params_from_jax(tree, CPU)


def _prompt(seed=9, shape=(2, 7)):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def test_converter_carries_every_leaf(weights):
    tree, params = weights
    for key in ("embed", "pos", "out_norm"):
        np.testing.assert_array_equal(params[key].numpy(), tree[key])
    for jb, tb in zip(tree["blocks"], params["blocks"]):
        assert set(tb) == set(jb)
        for key in jb:
            np.testing.assert_array_equal(tb[key].numpy(), jb[key])
    bf = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree), CPU)
    assert bf["embed"].dtype is torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jnp.asarray(tree["embed"], jnp.bfloat16), np.float32))
    moe = {**tree, "blocks": [{"moe": {}}]}
    with pytest.raises(ValueError, match="MoE"):
        params_from_jax(moe, CPU)


def test_forward_matches(weights):
    tree, params = weights
    toks = _prompt()
    want = np.asarray(jtr.forward(jtr.TransformerConfig(**TINY), tree,
                                  jnp.asarray(toks)))
    got = ttr.forward(ttr.TransformerConfig(**TINY), params,
                      torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("decode_attn", ["xla", "pallas"])
def test_prefill_and_decode_steps_match(weights, decode_attn):
    """prefill, then teacher-forced decode_steps; logits and caches agree
    with JAX's (its "pallas" path runs the kernel in interpret mode)."""
    tree, params = weights
    jcfg = jtr.TransformerConfig(**TINY, decode_attn=decode_attn)
    tcfg = ttr.TransformerConfig(**TINY, decode_attn=decode_attn)
    toks = _prompt()
    forced = _prompt(seed=3, shape=(2, 4))
    jl, jc, jpos = jdec.prefill(jcfg, tree, jnp.asarray(toks),
                                jdec.init_cache(jcfg, 2))
    tl, tc, tpos = tdec.prefill(tcfg, params, torch.from_numpy(toks),
                                tdec.init_cache(tcfg, 2, device=CPU))
    assert int(jpos) == tpos == 7
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    for i in range(forced.shape[1]):
        jl, jc = jdec.decode_step(jcfg, tree, jnp.asarray(forced[:, i]),
                                  jnp.int32(tpos + i), jc)
        tl, tc = tdec.decode_step(tcfg, params, torch.from_numpy(forced[:, i]),
                                  tpos + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL)
    for jlayer, tlayer in zip(jc, tc):
        for key in ("k", "v"):
            np.testing.assert_allclose(tlayer[key].numpy(),
                                       np.asarray(jlayer[key]),
                                       rtol=RTOL, atol=ATOL)


def test_decode_step_matches_forward(weights):
    """Cached decoding against the port's own uncached oracle."""
    _, params = weights
    cfg = ttr.TransformerConfig(**TINY, decode_attn="kernel")
    toks = torch.from_numpy(_prompt(shape=(2, 10)))
    full = ttr.forward(cfg, params, toks)
    _, cache, pos = tdec.prefill(cfg, params, toks[:, :6],
                                 tdec.init_cache(cfg, 2, device=CPU))
    for i in range(6, 10):
        logits, cache = tdec.decode_step(cfg, params, toks[:, i], i, cache)
        torch.testing.assert_close(logits, full[:, i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("decode_attn,cache_len", [
    ("xla", 0), ("pallas", 0), ("pallas", 24), ("xla", 24)])
def test_greedy_generate_token_exact(weights, decode_attn, cache_len):
    tree, params = weights
    prompt = _prompt()
    want = np.asarray(jdec.make_generate(
        jtr.TransformerConfig(**TINY, decode_attn=decode_attn),
        cache_len=cache_len)(tree, jnp.asarray(prompt), 8))
    got = tdec.make_generate(
        ttr.TransformerConfig(**TINY, decode_attn=decode_attn),
        cache_len=cache_len)(params, torch.from_numpy(prompt), 8)
    assert got.dtype is torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_bf16_serving_token_exact(weights):
    """bfloat16 weights and cache (the serve_dtype knob) in both packages:
    JAX promotes f32 @ bf16 to f32 and the port upcasts at use, so the
    tokens still agree."""
    tree, _ = weights
    tree_bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     tree)
    params_bf = params_from_jax(tree, CPU, torch.bfloat16)
    prompt = _prompt()
    want = np.asarray(jdec.make_generate(jtr.TransformerConfig(**TINY))(
        tree_bf, jnp.asarray(prompt), 8))
    got = tdec.make_generate(ttr.TransformerConfig(**TINY, decode_attn="kernel"))(
        params_bf, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_uses_the_generator(weights):
    _, params = weights
    gen_fn = tdec.make_generate(ttr.TransformerConfig(**TINY), temperature=1.0)
    prompt = torch.from_numpy(_prompt())

    def run(seed):
        return gen_fn(params, prompt, 8,
                      torch.Generator(device=CPU).manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert a.shape == (2, 15) and a.dtype is torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < 64
    torch.testing.assert_close(a, b)
    assert not torch.equal(a[:, 7:], c[:, 7:])
    torch.testing.assert_close(a[:, :7], prompt)


def test_generate_rejects_overlong_requests(weights):
    _, params = weights
    gen_fn = tdec.make_generate(ttr.TransformerConfig(**TINY), cache_len=16)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        gen_fn(params, torch.from_numpy(_prompt()), 10)
    with pytest.raises(ValueError, match="exceeds the model's max_seq"):
        tdec.make_generate(ttr.TransformerConfig(**TINY), cache_len=65)


def test_init_params_distribution():
    cfg = ttr.TransformerConfig(vocab=512, dim=64, heads=4, layers=2,
                                max_seq=128)
    p = ttr.init_params(cfg, seed=3, device="cpu")
    ref_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, jax.eval_shape(
            lambda: jtr.init_params(jtr.TransformerConfig(
                vocab=512, dim=64, heads=4, layers=2, max_seq=128))))
    assert tuple(p["embed"].shape) == ref_shapes["embed"]
    for tb, jb in zip(p["blocks"], ref_shapes["blocks"]):
        assert {k: tuple(t.shape) for k, t in tb.items()} == jb
        torch.testing.assert_close(tb["ln1"], torch.ones(64))
    assert abs(p["embed"].std().item() - 0.02) < 1e-3
    assert abs(p["embed"].mean().item()) < 1e-3
    torch.testing.assert_close(p["embed"],
                               ttr.init_params(cfg, 3, "cpu")["embed"])
    assert not torch.equal(p["embed"], ttr.init_params(cfg, 4, "cpu")["embed"])


def test_config_names_and_devices():
    assert ttr.TransformerConfig(decode_attn="xla").decode_attn == "dense"
    assert ttr.TransformerConfig(decode_attn="pallas").decode_attn == "kernel"
    with pytest.raises(ValueError):
        ttr.TransformerConfig(decode_attn="flash")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.init_params(ttr.TransformerConfig())    # default: the card


def test_serving_entry_shape_rule_and_steps(monkeypatch):
    from nnstreamer_tpu_torch.core import TensorSpec, TensorsInfo

    assert tlm.base.cfg.decode_attn == "kernel"
    serve = tlm.tiny.make(device="cpu")
    info = serve.output_info(TensorsInfo.of(TensorSpec((4, 6), "int32")))
    assert info.specs[0].shape == (4, 14)
    assert info.specs[0].dtype.value == "int32"
    with pytest.raises(ValueError, match="exceeds max_seq"):
        serve.output_info(TensorsInfo.of(TensorSpec((4, 60), "int32")))
    with pytest.raises(ValueError, match="int32"):
        serve.output_info(TensorsInfo.of(TensorSpec((4, 6), "float32")))
    (out,) = serve(torch.from_numpy(_prompt(shape=(4, 6))))
    assert tuple(out.shape) == (4, 14)
    monkeypatch.setenv("NNS_LM_STEPS", "3")
    (out,) = replace(tlm.tiny, serve_dtype="bfloat16",
                     cache_len=16).make("cpu")(torch.from_numpy(_prompt()))
    assert tuple(out.shape) == (2, 10)
    with pytest.raises(ValueError, match="serve_dtype"):
        replace(tlm.tiny, serve_dtype="int8").make("cpu")
