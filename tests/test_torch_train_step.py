"""The port's transformer training path (models/transformer.py: forward
with ``return_aux``, ``loss_fn``, ``make_train_step``) and MoE serving
(models/decoding.py) against nnstreamer_tpu's, on the same weights
(``init_params`` of the JAX package through ``params_from_jax``) and
tokens from ``np.random.default_rng``, both on the CPU.

Tolerances: logits and losses within 2e-5 absolute, parameters after
three SGD steps within 2e-5 absolute and 1e-4 relative (both sum in
float32, in different orders); greedy tokens exactly equal."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decoding as RD
from nnstreamer_tpu.models import transformer as RT
from nnstreamer_tpu.parallel.mesh import make_mesh as r_make_mesh
from nnstreamer_tpu_torch.models import decoding as PD
from nnstreamer_tpu_torch.models import transformer as PT
from nnstreamer_tpu_torch.models.convert import params_from_jax

ATOL, RTOL = 2e-5, 1e-4
CFGS = {
    "dense": dict(vocab=64, dim=32, heads=4, layers=2, max_seq=17),
    "moe": dict(vocab=64, dim=32, heads=4, layers=2, max_seq=17,
                moe_experts=4),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _both(kind, seed=0):
    rcfg = RT.TransformerConfig(**CFGS[kind])
    pcfg = PT.TransformerConfig(**CFGS[kind])
    tree = _numpy(RT.init_params(rcfg, seed=seed))
    return rcfg, pcfg, tree, params_from_jax(tree, device="cpu")


def _tokens(shape, vocab=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_forward_with_aux_matches_reference(kind):
    rcfg, pcfg, tree, params = _both(kind)
    toks = _tokens((3, 16))
    want, want_aux = RT.forward(rcfg, tree, jnp.asarray(toks), return_aux=True)
    got, got_aux = PT.forward(pcfg, params, torch.from_numpy(toks),
                              return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5
    if kind == "dense":
        assert float(got_aux) == 0.0


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_loss_fn_matches_reference(kind):
    rcfg, pcfg, tree, params = _both(kind, seed=1)
    toks = _tokens((4, 17), seed=1)
    want = float(RT.loss_fn(rcfg, tree, jnp.asarray(toks)))
    got = float(PT.loss_fn(pcfg, params, torch.from_numpy(toks)))
    assert abs(got - want) <= ATOL


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_trainer_model_config_loss_is_the_train_step_loss(kind, monkeypatch):
    """models/lm_train.py's ``loss_fn`` (the ``tensor_trainer`` config) on
    (inputs, targets) is the reference's ``loss_fn`` on the joined tokens,
    at this file's small width."""
    from nnstreamer_tpu_torch.models import lm_train

    rcfg, pcfg, tree, params = _both(kind, seed=3)
    monkeypatch.setattr(lm_train, "CFG", pcfg)
    toks = _tokens((4, 17), seed=3)
    t = torch.from_numpy(toks)
    got, extra = lm_train.loss_fn(params, [t[:, :-1]], [t[:, 1:]])
    want = float(RT.loss_fn(rcfg, tree, jnp.asarray(toks)))
    assert abs(float(got) - want) <= ATOL
    assert float(got) == float(PT.loss_fn(pcfg, params, t))
    assert 0.0 <= float(extra["accuracy"]) <= 1.0


def test_loss_includes_the_balance_term():
    """Aux weight 0 vs 1 differ by the aux term (≥ 1 for a softmax
    router), in both packages alike."""
    kw = dict(vocab=16, dim=8, heads=2, layers=1, max_seq=9, moe_experts=4,
              moe_aux_weight=1.0)
    rcfg, pcfg = RT.TransformerConfig(**kw), PT.TransformerConfig(**kw)
    tree = _numpy(RT.init_params(rcfg))
    params = params_from_jax(tree, device="cpu")
    toks = _tokens((2, 9), vocab=16)
    aux_p = (float(PT.loss_fn(pcfg, params, torch.from_numpy(toks)))
             - float(PT.loss_fn(replace(pcfg, moe_aux_weight=0.0), params,
                                torch.from_numpy(toks))))
    aux_r = (float(RT.loss_fn(rcfg, tree, jnp.asarray(toks)))
             - float(RT.loss_fn(replace(rcfg, moe_aux_weight=0.0), tree,
                                jnp.asarray(toks))))
    assert aux_p >= 0.9
    assert abs(aux_p - aux_r) <= 1e-5


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_three_meshless_steps_match_a_one_device_mesh(kind):
    rcfg, pcfg, tree, params = _both(kind, seed=2)
    toks = _tokens((4, 17), seed=2)
    mesh = r_make_mesh(jax.devices()[:1], {"dp": 1, "tp": 1, "sp": 1})
    rstep, rshard, rdata = RT.make_train_step(rcfg, mesh, lr=5e-2)
    rp = rshard(jax.tree_util.tree_map(jnp.asarray, tree))
    rt = jax.device_put(toks, rdata)
    pstep, pshard, pdata = PT.make_train_step(pcfg, None, lr=5e-2)
    pp, pt = pshard(params), pdata(toks)
    for i in range(3):
        rp, rloss = rstep(rp, rt)
        pp, ploss = pstep(pp, pt)
        assert abs(float(ploss) - float(rloss)) <= ATOL, i
    want = params_from_jax(_numpy(rp), device="cpu")
    for g, w in zip(PT.tree_leaves(pp), PT.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_moe_steps_lower_the_loss():
    _, pcfg, _, params = _both("moe", seed=3)
    toks = torch.from_numpy(_tokens((4, 17), seed=3))
    step, _, _ = PT.make_train_step(pcfg, None, lr=5e-2)
    losses = []
    for _ in range(8):
        params, loss = step(params, toks)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_unknown_attn_impl_rejected():
    with pytest.raises(ValueError, match="attn_impl"):
        PT.TransformerConfig(attn_impl="magic")


@pytest.mark.parametrize("attn", ["dense", "kernel"])
def test_moe_greedy_generation_equals_reference(attn):
    """An MoE LM served through decoding (prefill, then decode steps,
    each routing its own tokens) picks the reference's greedy tokens;
    ``kernel`` runs the CUDA kernels' plain versions on the CPU."""
    kw = dict(vocab=64, dim=32, heads=4, layers=2, max_seq=32, moe_experts=4)
    rcfg = RT.TransformerConfig(**kw)
    pcfg = PT.TransformerConfig(**kw, decode_attn=attn, prefill_attn=attn)
    tree = _numpy(RT.init_params(rcfg, seed=4))
    prompt = _tokens((3, 6), seed=4)
    want = np.asarray(RD.make_generate(rcfg)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(prompt), 10))
    got = PD.make_generate(pcfg)(params_from_jax(tree, device="cpu"),
                                 torch.from_numpy(prompt), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_params_convert_and_shard_round_trip():
    _, pcfg, tree, params = _both("moe")
    assert set(params["blocks"][0]) == {"ln1", "wqkv", "wo", "ln2", "moe"}
    for k in ("wr", "w1", "w2"):
        np.testing.assert_array_equal(params["blocks"][1]["moe"][k].numpy(),
                                      tree["blocks"][1]["moe"][k])
    # meshless sharding is the identity
    assert PT.shard_params(pcfg, None, params) is params
