"""The split plan of the CUDA decode kernel (ops/decode_attention.py), on
the CPU.

The kernel divides the visible prefix [0, pos] of each (b, h) over
``decode_splits`` blocks in shares of ``split_share`` keys and combines the
blocks' partial softmax results (m, l, acc), in log2 units, in the last
block. The kernel runs only on the card; these tests hold its plan and its
combine formula, written out in PyTorch, against nnstreamer_tpu's Pallas
kernel in interpret mode with test_pallas_ops.py's tolerances (rtol 2e-4,
atol 2e-5: both accumulate in f32, in another order)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops.pallas_decode import cached_decode_attention
from nnstreamer_tpu_torch.ops.decode_attention import (
    MAX_SHARE,
    SHARE_ALIGN,
    decode_splits,
    split_share,
)

RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("rows,t_len,sms,want", [
    (128, 2048, 132, 6),      # the main path: lm_serving base, batch 8
    (256, 2048, 132, 3),
    (1, 2048, 132, 128),      # one row: shares of 16 keys
    (16, 64, 132, 4),         # a short cache caps the splits at T / 16
    (4096, 2048, 132, 1),
    (1, 1 << 16, 132, 792),
    (1024, 1 << 16, 132, 4),  # a share holds at most MAX_SHARE keys
])
def test_splits_are_fixed_by_the_shapes(rows, t_len, sms, want):
    n = decode_splits(rows, t_len, sms)
    assert n == want
    assert math.ceil(t_len / n) <= MAX_SHARE


@pytest.mark.parametrize("n_split", [1, 3, 6, 128])
@pytest.mark.parametrize("pos", [0, 1, 15, 16, 95, 96, 97, 543, 2047])
def test_shares_cover_the_prefix_once(n_split, pos):
    share = split_share(pos, n_split)
    assert share % SHARE_ALIGN == 0 and share >= SHARE_ALIGN
    covered = [t for s in range(n_split)
               for t in range(s * share, min((s + 1) * share, pos + 1))]
    assert covered == list(range(pos + 1))


def _split_decode(q, k, v, pos, n_split):
    """The kernel's arithmetic: per split, scores in log2 units, their max
    m_i, sum l_i and unnormalised acc_i; then the combine."""
    D = q.shape[-1]
    share = split_share(pos, n_split)
    s = (q * (D ** -0.5 * math.log2(math.e))) @ k.transpose(-1, -2)
    parts = []
    for t0 in range(0, pos + 1, share):
        t1 = min(t0 + share, pos + 1)
        si = s[..., t0:t1]
        m = si.amax(-1, keepdim=True)
        p = torch.exp2(si - m)
        parts.append((m, p.sum(-1, keepdim=True), p @ v[:, :, t0:t1]))
    assert len(parts) <= n_split
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp2(m - mx) for m, _, _ in parts]
    num = sum(wi * a for wi, (_, _, a) in zip(w, parts))
    den = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    return num / den


@pytest.mark.parametrize("pos", [0, 47, 48, 49, 127])
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_split_combine_matches_pallas_kernel(pos, n_split):
    rng = np.random.default_rng(pos * 10 + n_split)
    q = rng.standard_normal((2, 3, 1, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 128, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(cached_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, block_k=32,
        interpret=True))
    got = _split_decode(*map(torch.from_numpy, (q, k, v)), pos, n_split)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
