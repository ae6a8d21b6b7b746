"""The port's switch MoE (nnstreamer_tpu_torch/parallel/moe.py) against
nnstreamer_tpu's (parallel/moe.py) on the same weights and tokens, both on
the CPU.

Weights come from the JAX package's ``init_moe_params`` (or are built with
numpy from a seed); tokens from ``np.random.default_rng``. Tolerances:
float32 outputs within 1e-5 absolute, gradients within 1e-5 absolute and
1e-4 relative (the two sum the expert products in different orders);
bfloat16 activations within 2e-2 (the reference's own bound between its
two dispatch forms). Token drops are compared exactly (which tokens give
zero)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.parallel import moe as R
from nnstreamer_tpu_torch.parallel import moe as P

ATOL, RTOL = 1e-5, 1e-4


def _params(dim=8, hidden=16, experts=4, seed=0):
    return {k: np.array(v) for k, v in R.init_moe_params(
        jax.random.PRNGKey(seed), dim, hidden, experts).items()}


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
@pytest.mark.parametrize("capacity_factor", [0.25, 0.75, 1.25, 2.0])
def test_moe_ffn_matches_reference(dispatch, capacity_factor):
    params = _params(experts=4, seed=7)
    x = _x((3, 10, 8), 11)
    want = np.asarray(R.moe_ffn(params, jnp.asarray(x),
                                capacity_factor=capacity_factor,
                                dispatch=dispatch))
    got = P.moe_ffn(_t(params), torch.from_numpy(x),
                    capacity_factor=capacity_factor, dispatch=dispatch)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the same tokens are dropped (contribute exactly zero)
    dropped_w = np.abs(want).sum(-1) == 0
    dropped_g = np.abs(got.numpy()).sum(-1) == 0
    np.testing.assert_array_equal(dropped_g, dropped_w)


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_capacity_overflow_drops_the_same_tokens(dispatch):
    params = _params(experts=2)
    params["wr"] = np.zeros_like(params["wr"])
    params["wr"][:, 0] = 10.0                    # every token → expert 0
    x = np.ones((1, 8, 8), np.float32)
    x[0, :, 0] += np.arange(8, dtype=np.float32)  # distinct tokens
    want = np.asarray(R.moe_ffn(params, jnp.asarray(x), capacity_factor=0.25,
                                dispatch=dispatch))
    got = P.moe_ffn(_t(params), torch.from_numpy(x), capacity_factor=0.25,
                    dispatch=dispatch).numpy()
    kept = np.abs(got).sum(-1).reshape(-1) > 0
    assert kept.tolist() == [True] + [False] * 7     # first come, first kept
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bf16_activations_promote_through_f32_experts():
    params = _params(experts=4, seed=3)
    x = _x((2, 16, 8), 5)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, a: R.moe_ffn(p, a))(params, xj),
                      np.float32)
    got = P.moe_ffn(_t(params), torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32          # as JAX promotes
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


def test_bad_dispatch_rejected():
    with pytest.raises(ValueError, match="dispatch"):
        P.moe_ffn(_t(_params()), torch.ones(2, 8), dispatch="magic")


def test_load_balance_loss_matches_reference():
    params = _params()
    x = _x((64, 8), 3)
    logits = x @ params["wr"]
    expert = logits.argmax(-1)
    want = float(R.load_balance_loss(jnp.asarray(logits), jnp.asarray(expert)))
    got = float(P.load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(expert)))
    assert abs(got - want) <= 1e-6
    assert 0.9 <= got <= 4.0 + 1e-6


def _grads_both(params, x, r, capacity_factor, dispatch):
    def jloss(p, a):
        y, aux = R.moe_ffn(p, a, capacity_factor=capacity_factor,
                           dispatch=dispatch, return_aux=True)
        return jnp.sum(y * r) + 0.5 * aux
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = P.moe_ffn(tp, tx, capacity_factor=capacity_factor,
                       dispatch=dispatch, return_aux=True)
    (torch.sum(y * torch.from_numpy(r)) + 0.5 * aux).backward()
    return jg_p, jg_x, {k: v.grad for k, v in tp.items()}, tx.grad


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_grads_match_reference(dispatch):
    params = _params(experts=4, seed=2)
    x = _x((2, 9, 8), 4)
    r = _x((2, 9, 8), 6)
    jg_p, jg_x, tg_p, tg_x = _grads_both(params, x, r, 0.75, dispatch)
    for k in ("wr", "w1", "w2"):
        np.testing.assert_allclose(tg_p[k].numpy(), np.asarray(jg_p[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tg_x.numpy(), np.asarray(jg_x), atol=ATOL,
                               rtol=RTOL)


def test_gate_tie_splits_the_gradient_as_jax_does():
    """Experts 0 and 1 share the router column, so every token's top two
    probabilities tie: JAX's ``max`` splits the gate's gradient evenly
    over them, and so must the port (``amax``; ``torch.max(dim)`` would
    send it all to one column)."""
    params = _params(experts=4, seed=9)
    params["wr"][:, 1] = params["wr"][:, 0]
    params["wr"][:, 0] += 0.5                  # experts 0/1 lead every token
    params["wr"][:, 1] += 0.5
    x = np.abs(_x((1, 6, 8), 8))
    r = _x((1, 6, 8), 10)
    jg_p, _, tg_p, _ = _grads_both(params, x, r, 2.0, "scatter")
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, 8) @ params["wr"]),
                          -1)
    assert bool((probs[:, 0] == probs[:, 1]).all())
    assert bool((probs.argmax(-1) == 0).all())
    np.testing.assert_allclose(tg_p["wr"].numpy(), np.asarray(jg_p["wr"]),
                               atol=ATOL, rtol=RTOL)


def test_capacity_is_ceil_of_tokens_over_experts():
    params = _params(experts=4)
    x = torch.from_numpy(_x((12, 8), 1))
    _, _, expert, _, pos, keep = P._route(_t(params), x, 4, (12,))
    counts = np.bincount(expert.numpy(), minlength=4)
    assert int(keep.sum()) == int(np.minimum(counts, 4).sum())
    assert max(1, math.ceil(12 / 4 * 1.25)) == 4
