"""The CUDA flash-attention kernel against its plain PyTorch version, on
the card (marker ``cuda``; skips without a card and nvcc). This file needs
neither JAX nor nnstreamer_tpu, so it runs where they are not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_flash_attention_cuda.py

Limits: f32 within rtol 2e-4 / atol 2e-5 (both accumulate in f32, in
another order). A bf16 output is the kernel's f32 result rounded once to
bf16, so it is held against the plain version's f32 result on the same
inputs with half a bf16 step (2^-8 relative) added to rtol.
"""
import pytest
import torch

from nnstreamer_tpu_torch.ops import build
from nnstreamer_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    flash_attention_plain,
)

RTOL, ATOL = 2e-4, 2e-5
BF16_HALF_STEP = 2.0 ** -8


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    try:
        build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


def _check(q, k, v, causal, block):
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal, block, block)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype is q.dtype and got.shape == q.shape
    want = flash_attention_plain(q.float(), k.float(), v.float(), causal,
                                 block, block)
    rtol = RTOL + (BF16_HALF_STEP if q.dtype is torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_at_prefill_shape(cuda_card, causal, dtype):
    g = torch.Generator(device=cuda_card).manual_seed(0)
    q, k, v = (torch.randn(8, 16, 512, 64, device=cuda_card, generator=g)
               .to(dtype) for _ in range(3))
    _check(q, k, v, causal, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [
    ((2, 3, 200, 64), 200), ((1, 2, 40, 16), 8), ((2, 2, 64, 32), 32),
    ((1, 2, 130, 128), 130)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_ragged_tiles_and_head_dims(cuda_card, shape, block, causal):
    g = torch.Generator(device=cuda_card).manual_seed(1)
    q, k, v = (torch.randn(shape, device=cuda_card, generator=g)
               for _ in range(3))
    _check(q, k, v, causal, block)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 40, 64, 65, 200, 512])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_kernel_every_length_and_head_dim(cuda_card, dtype, causal, S, D):
    """Ragged lengths (a last tile of 1, 40, 8 rows) and whole tiles, one
    block of S (the prefill's call), at every head dim the kernel takes."""
    g = torch.Generator(device=cuda_card).manual_seed(S * 1000 + D)
    q, k, v = (torch.randn(2, 3, S, D, device=cuda_card, generator=g)
               .to(dtype) for _ in range(3))
    _check(q, k, v, causal, S)


@pytest.mark.cuda
def test_kernel_errors_on_card(cuda_card):
    q = torch.randn(1, 2, 64, 64, device=cuda_card)
    with pytest.raises(ValueError, match="must divide"):
        flash_attention(q, q, q, block_q=48, block_k=48)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        flash_attention(t, q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
        flash_attention(h, h, h)
    with pytest.raises(ValueError, match="head dim 48"):
        r = torch.randn(1, 2, 64, 48, device=cuda_card)
        flash_attention(r, r, r)
