"""The port's flash attention (ops/flash_attention.py) and the prefill that
runs through it, against nnstreamer_tpu's Pallas kernel (interpret mode on
the CPU) and its XLA prefill, on the same numpy inputs. On CPU tensors the
wrapper takes its plain version, so these tests hold that version — the one
chip_smoke.py holds the CUDA kernel against on the card — to the TPU
kernel. Attention agrees within rtol 2e-4 / atol 2e-5 (test_pallas_ops.py's
limits: both accumulate in f32, in another order); for bf16 inputs that is
checked in f32 on the same bf16 values, and the bf16 outputs, each an f32
result rounded once, may then differ by one bf16 step (at most 2^-7
relative) where an f32 result lies next to a rounding midpoint. The
prefill's logits and cache agree within 1e-5 (the same f32 math as the
dense XLA path)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decoding as jdec
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu.ops.pallas_attention import flash_attention as jflash
from nnstreamer_tpu_torch.models import decoding as tdec
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.models.convert import params_from_jax
from nnstreamer_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

RTOL, ATOL = 2e-4, 2e-5
BF16_STEP = 2.0 ** -7   # one step of bf16's 8 significant bits, relative
PREFILL_TOL = 1e-5
TINY = dict(vocab=64, dim=32, heads=4, layers=2, max_seq=64)
CPU = torch.device("cpu")


def _qkv(S, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((2, 2, S, 16)).astype(np.float32)
              for _ in range(3)]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    # the port gets the same values (bf16-rounded where the dtype is bf16)
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.float32 if dtype == jnp.float32 else torch.bfloat16) for a in jx]
    return jx, tt


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk", [(64, 32, 32), (64, 64, 16)])
def test_flash_matches_pallas_kernel(causal, S, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(S, dtype)
    want = jflash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                  interpret=True)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert flash_attention.launches == before   # CPU: the plain version
    assert got.dtype is q.dtype and tuple(got.shape) == (2, 2, S, 16)
    torch.testing.assert_close(
        flash_attention_plain(q, k, v, causal, bq, bk), got, rtol=0, atol=0)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        return
    # bf16: the algorithm in f32 on the same bf16 values, at the limits
    want32 = jflash(*(a.astype(jnp.float32) for a in (jq, jk, jv)),
                    causal=causal, block_q=bq, block_k=bk, interpret=True)
    got32 = flash_attention(q.float(), k.float(), v.float(), causal, bq, bk)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32),
                               rtol=RTOL, atol=ATOL)
    # the port's bf16 output is that f32 result rounded once ...
    torch.testing.assert_close(got, got32.to(torch.bfloat16), rtol=0, atol=0)
    # ... and so is the Pallas kernel's: at most one bf16 step apart
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=RTOL + BF16_STEP, atol=ATOL)


def test_flash_rejects_ragged_seq_as_jax_does():
    (jq, _, _), (q, _, _) = _qkv(100, jnp.float32)
    with pytest.raises(ValueError, match="must divide"):
        jflash(jq, jq, jq, block_q=64, block_k=64, interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention_plain(q, q, q, block_q=64, block_k=30)
    # blocks are clipped to S first, as in JAX: one block of 100 is fine
    assert flash_attention(q, q, q, block_q=128, block_k=128).shape == q.shape


def test_flash_checks_types_and_shapes():
    (_, _, _), (q, k, _) = _qkv(16, jnp.float32)
    with pytest.raises(TypeError, match="one float dtype"):
        flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, k[:, :, :8], k)
    with pytest.raises(ValueError, match=r"\(B, H, S, D\)"):
        flash_attention(q[0], k[0], k[0])


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jtr.TransformerConfig(**TINY), seed=0))
    return tree, params_from_jax(tree, CPU)


@pytest.mark.parametrize("S", [7, 32, 40])
def test_kernel_prefill_matches_jax_prefill(weights, S):
    """prefill_attn="kernel" on the CPU (the flash wrapper's plain version,
    called with one block of S, so any S meets the block contract) against
    JAX's dense prefill."""
    tree, params = weights
    toks = np.random.default_rng(S).integers(0, 64, (2, S)).astype(np.int32)
    jcfg = jtr.TransformerConfig(**TINY)
    tcfg = ttr.TransformerConfig(**TINY, prefill_attn="pallas")
    assert tcfg.prefill_attn == "kernel"
    jl, jc, jpos = jdec.prefill(jcfg, tree, jnp.asarray(toks),
                                jdec.init_cache(jcfg, 2))
    tl, tc, tpos = tdec.prefill(tcfg, params, torch.from_numpy(toks),
                                tdec.init_cache(tcfg, 2, device=CPU))
    assert int(jpos) == tpos == S
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    for jlayer, tlayer in zip(jc, tc):
        for key in ("k", "v"):
            got, want = tlayer[key].numpy(), np.asarray(jlayer[key])
            np.testing.assert_allclose(got, want, rtol=PREFILL_TOL,
                                       atol=PREFILL_TOL)
            assert not got[:, :, S:].any()   # nothing written past S


def test_prefill_attn_names():
    assert ttr.TransformerConfig(prefill_attn="xla").prefill_attn == "dense"
    assert ttr.TransformerConfig(prefill_attn="pallas").prefill_attn == "kernel"
    with pytest.raises(ValueError, match="prefill_attn"):
        ttr.TransformerConfig(prefill_attn="flash")
