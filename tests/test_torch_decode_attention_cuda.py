"""The CUDA decode-attention kernel against its plain PyTorch version, on
the card (marker ``cuda``; skips without a card and nvcc). This file needs
neither JAX nor nnstreamer_tpu, so it runs where they are not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_decode_attention_cuda.py
"""
import pytest
import torch

from nnstreamer_tpu_torch.ops import build
from nnstreamer_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

# both accumulate in float32 (a bf16 cache widens exactly): summation order
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    try:
        build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 127, 128, 1023, 2047])
def test_kernel_matches_plain_on_card(cuda_card, dtype, pos):
    g = torch.Generator(device=cuda_card).manual_seed(0)
    q = torch.randn(8, 16, 1, 64, device=cuda_card, generator=g)
    k, v = (torch.randn(8, 16, 2048, 64, device=cuda_card, generator=g)
            .to(dtype) for _ in range(2))
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, 128)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, pos, 128),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_pos_tensor_and_errors_on_card(cuda_card):
    g = torch.Generator(device=cuda_card).manual_seed(1)
    q = torch.randn(2, 3, 1, 16, device=cuda_card, generator=g)
    k, v = (torch.randn(2, 3, 64, 16, device=cuda_card, generator=g)
            for _ in range(2))
    pos = torch.tensor([40], dtype=torch.int32, device=cuda_card)
    torch.testing.assert_close(decode_attention(q, k, v, pos, 16),
                               decode_attention_plain(q, k, v, 40, 16),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, 3, 16)
    with pytest.raises(ValueError, match="one int32"):
        decode_attention(q, k, v, pos.cpu(), 16)
