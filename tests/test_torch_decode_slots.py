"""Decode attention and the decode step with one position per slot, the
port against nnstreamer_tpu.

nnstreamer_tpu's continuous engine vmaps ``decode_step`` over its slots,
each at its own position; with ``decode_attn="pallas"`` the vmap reaches
its Pallas kernel. The port takes the positions as one (B,) int32 vector:
``decode_attention_plain`` (the CUDA kernel's plain version, what the
wrapper runs on CPU tensors) masks each row at its own position, and
``decode_step`` writes each row's K/V at its own position.

Oracles: the Pallas kernel in interpret mode run on each slot alone, and
``jax.vmap`` of it over the slots, with test_pallas_ops.py's tolerances
(rtol 2e-4, atol 2e-5); nnstreamer_tpu's vmapped ``decode_step``
(``serving/lm_engine.py``'s ``_one_step``) for the batched step, its
logits within rtol 1e-4 / atol 1e-5 (the same float32 math summed in
another order, as test_torch_model.py holds it) and the written cache
rows within the same."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decoding as jdec
from nnstreamer_tpu.models import lm_serving as jlm
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu.ops.pallas_decode import cached_decode_attention
from nnstreamer_tpu_torch.models import decoding as tdec
from nnstreamer_tpu_torch.models import lm_serving as tlm
from nnstreamer_tpu_torch.models.convert import params_from_jax
from nnstreamer_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

RTOL, ATOL = 2e-4, 2e-5          # tests/test_pallas_ops.py:40-75
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
S, H, T, D = 4, 3, 64, 16
SLOT_POS = [0, 17, 31, 63]


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, H, 1, D)).astype(np.float32),
            rng.standard_normal((S, H, T, D)).astype(np.float32),
            rng.standard_normal((S, H, T, D)).astype(np.float32))


@pytest.mark.parametrize("block_k", [16, 32, 64])
def test_plain_matches_pallas_per_slot(block_k):
    q, k, v = _inputs()
    pos = torch.tensor(SLOT_POS, dtype=torch.int32)
    got = decode_attention_plain(*map(torch.from_numpy, (q, k, v)), pos,
                                 block_k).numpy()
    for b, p in enumerate(SLOT_POS):
        want = np.asarray(cached_decode_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), p, block_k=block_k, interpret=True))
        np.testing.assert_allclose(got[b:b + 1], want, rtol=RTOL, atol=ATOL)


def test_plain_matches_vmapped_pallas():
    q, k, v = _inputs(seed=2)

    def one(qs, ks, vs, p):
        return cached_decode_attention(qs[None], ks[None], vs[None], p,
                                       block_k=16, interpret=True)[0]

    want = np.asarray(jax.vmap(one)(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    jnp.asarray(SLOT_POS, jnp.int32)))
    pos = torch.tensor(SLOT_POS, dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(*map(torch.from_numpy, (q, k, v)), pos, 16)
    assert decode_attention.launches == before   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_vector_of_equal_positions_is_the_scalar_case():
    q, k, v = map(torch.from_numpy, _inputs(seed=3))
    vec = torch.full((S,), 40, dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q, k, v, vec, 32),
                               decode_attention(q, k, v, 40, 32),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", [torch.zeros(3, dtype=torch.int32),
                                 torch.zeros(S, dtype=torch.int64),
                                 torch.zeros((S, 1), dtype=torch.int32)],
                         ids=["length", "dtype", "rank"])
def test_pos_vector_is_validated(bad):
    q, k, v = map(torch.from_numpy, _inputs())
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, bad, 16)


# -- the batched decode step ---------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jlm.tiny.cfg, seed=jlm.tiny.seed))


def _ref_vmapped_step(cfg, params, toks, pos, cache):
    """nnstreamer_tpu's dense engine step: decode_step vmapped over the
    slots, each a batch-1 decode at its own position."""
    def one(token, p, c):
        return jdec.decode_step(cfg, params, token, p, c)

    c = [{"k": jnp.asarray(l["k"])[:, None], "v": jnp.asarray(l["v"])[:, None]}
         for l in cache]
    logits, c = jax.vmap(one)(jnp.asarray(toks)[:, None],
                              jnp.asarray(pos, jnp.int32), c)
    return (np.asarray(logits[:, 0]),
            [{n: np.asarray(l[n][:, 0]) for n in ("k", "v")} for l in c])


@pytest.mark.parametrize("attn", [("xla", "dense"), ("pallas", "kernel")],
                         ids=["dense", "kernel"])
def test_batched_step_matches_vmapped_reference(tree, attn):
    ref_attn, port_attn = attn
    jcfg = replace(jlm.tiny.cfg, decode_attn=ref_attn)
    tcfg = replace(tlm.tiny.cfg, decode_attn=port_attn)
    slots = 4
    rng = np.random.default_rng(5)
    Tm, Hh, Dh = jcfg.max_seq, jcfg.heads, jcfg.head_dim
    cache = [{n: rng.standard_normal((slots, Hh, Tm, Dh)).astype(np.float32)
              for n in ("k", "v")} for _ in range(jcfg.layers)]
    toks = rng.integers(0, jcfg.vocab, slots).astype(np.int32)
    pos = np.array([0, 9, 33, Tm - 1], np.int32)
    want_logits, want_cache = _ref_vmapped_step(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree), toks, pos, cache)
    tcache = [{n: torch.from_numpy(l[n].copy()) for n in ("k", "v")}
              for l in cache]
    logits, tcache = tdec.decode_step(
        tcfg, params_from_jax(tree, "cpu"), torch.from_numpy(toks),
        torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(logits.numpy(), want_logits,
                               rtol=STEP_RTOL, atol=STEP_ATOL)
    for got, want in zip(tcache, want_cache):
        for n in ("k", "v"):
            np.testing.assert_allclose(got[n].numpy(), want[n],
                                       rtol=STEP_RTOL, atol=STEP_ATOL)


def test_step_past_the_cache_clamps_like_jax(tree):
    """A position past the cache writes (and reads) its last entry, as
    JAX clamps ``dynamic_update_slice``; the engines never step a live
    slot there, but an inactive one must not fault."""
    jcfg = replace(jlm.tiny.cfg, decode_attn="xla")
    tcfg = replace(tlm.tiny.cfg, decode_attn="dense")
    rng = np.random.default_rng(6)
    Tm = jcfg.max_seq
    cache = [{n: rng.standard_normal((2, jcfg.heads, Tm, jcfg.head_dim))
              .astype(np.float32) for n in ("k", "v")}
             for _ in range(jcfg.layers)]
    toks = np.array([3, 4], np.int32)
    pos = np.array([Tm, 5], np.int32)   # slot 0 past the end
    _, want_cache = _ref_vmapped_step(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree), toks, pos, cache)
    tcache = [{n: torch.from_numpy(l[n].copy()) for n in ("k", "v")}
              for l in cache]
    _, tcache = tdec.decode_step(tcfg, params_from_jax(tree, "cpu"),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(pos), tcache)
    for got, want in zip(tcache, want_cache):
        np.testing.assert_allclose(got["k"].numpy(), want["k"],
                                   rtol=STEP_RTOL, atol=STEP_ATOL)
