"""Cached-decode attention in the port (ops/decode_attention.py).

On the CPU the wrapper runs the plain PyTorch version; it is held against
nnstreamer_tpu's Pallas kernel in interpret mode and against the dense
masked oracle, with test_pallas_ops.py's tolerances (rtol 2e-4, atol 2e-5).
The CUDA kernel itself runs only on the card:
test_torch_decode_attention_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops.pallas_decode import cached_decode_attention
from nnstreamer_tpu_torch.ops import build
from nnstreamer_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

RTOL, ATOL = 2e-4, 2e-5
B, H, T, D = 2, 3, 64, 16


def _inputs(seed=1, t=T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, 1, D)).astype(np.float32),
            rng.standard_normal((B, H, t, D)).astype(np.float32),
            rng.standard_normal((B, H, t, D)).astype(np.float32))


def _dense_oracle(q, k, v, pos):
    """decode_step's masked dense path, in numpy float64."""
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(np.arange(k.shape[2]) <= pos, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("pos", [0, 1, 31, 32, 63])
@pytest.mark.parametrize("block_k", [16, 32, 64])
def test_matches_pallas_kernel_and_dense(pos, block_k):
    q, k, v = _inputs()
    want = np.asarray(cached_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
        block_k=block_k, interpret=True))
    before = decode_attention.launches
    got = decode_attention(*map(torch.from_numpy, (q, k, v)), pos, block_k)
    assert decode_attention.launches == before   # CPU: the plain version
    assert got.dtype is torch.float32 and tuple(got.shape) == (B, H, 1, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _dense_oracle(q, k, v, pos),
                               rtol=RTOL, atol=ATOL)


def test_pos_as_device_tensor():
    q, k, v = map(torch.from_numpy, _inputs())
    pos = torch.tensor([31], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q, k, v, pos, 32),
                               decode_attention(q, k, v, 31, 32))


def test_bf16_cache():
    """A bfloat16 cache. On the same bf16 cache the plain version and the
    Pallas kernel both widen to f32 exactly and accumulate in f32, so the
    f32 tolerance holds; against the f32 cache the looser tolerance covers
    the cache's rounding (bf16 keeps 8 significant bits, ~4e-3 relative
    per value)."""
    q, k, v = _inputs(seed=2)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    got = decode_attention(torch.from_numpy(q), kb, vb, 40, 16).numpy()
    same_cache = np.asarray(cached_decode_attention(
        jnp.asarray(q), jnp.asarray(kb.float().numpy(), jnp.bfloat16),
        jnp.asarray(vb.float().numpy(), jnp.bfloat16), 40, block_k=16,
        interpret=True))
    np.testing.assert_allclose(got, same_cache, rtol=RTOL, atol=ATOL)
    f32_cache = np.asarray(cached_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 40, block_k=16,
        interpret=True))
    np.testing.assert_allclose(got, f32_cache, rtol=1e-2, atol=1e-2)
    assert not np.allclose(got, f32_cache, rtol=RTOL, atol=ATOL)


def test_ragged_cache_raises():
    q = torch.zeros(1, 1, 1, 16)
    c = torch.zeros(1, 1, 100, 16)
    with pytest.raises(ValueError):
        decode_attention(q, c, c, 0, 64)
    with pytest.raises(ValueError):
        decode_attention_plain(q, c, c, 0, 64)


@pytest.mark.parametrize("bad", ["q_dtype", "kv_dtype", "shape", "mixed"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = map(torch.from_numpy, _inputs())
    if bad == "q_dtype":
        q, err = q.double(), TypeError
    elif bad == "kv_dtype":
        v, err = v.to(torch.bfloat16), TypeError
    elif bad == "shape":
        k, err = k[:, :, :, :8], ValueError
    else:   # one tensor off the CPU: never silently the plain version
        k, err = k.to("meta"), ValueError
    with pytest.raises(err):
        decode_attention(q, k, v, 3, 16)


def test_build_reports_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_kernels()
    assert build.library_path("decode_attention").name.startswith(
        "libdecode_attention-")
