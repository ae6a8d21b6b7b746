"""The CUDA decode-attention kernel against its plain PyTorch version, on
the card (marker ``cuda``; skips without a card and nvcc). This file needs
neither JAX nor nnstreamer_tpu, so it runs where they are not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_decode_attention_cuda.py

The kernel splits the prefix [0, pos] of each (b, h) over n_split blocks
(``decode_splits``) in shares of ``split_share(pos, n_split)`` keys and
combines the blocks' partial results; the cases below put pos on each side
of a share boundary, at the ends of the cache, at one row and at many, at
every head dim, and on a short cache.
"""
import pytest
import torch

from nnstreamer_tpu_torch.ops import build
from nnstreamer_tpu_torch.ops.decode_attention import (
    SHARE_ALIGN,
    decode_attention,
    decode_attention_plain,
    decode_splits,
    split_share,
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


def _inputs(dev, shape, dtype, seed):
    B, H, T, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, 1, D, device=dev, generator=g)
    k, v = (torch.randn(B, H, T, D, device=dev, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v


def _holds(q, k, v, pos, block_k):
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos, block_k)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, pos,
                                                           block_k),
                               rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full", [1, 4])
@pytest.mark.parametrize("side", [-1, 0, 1])
def test_split_boundaries(cuda_card, dtype, full, side):
    """pos + 1 = n_split * 16 * full fills every split exactly; one key
    less leaves the last split one short, one more grows the share."""
    shape = (8, 16, 2048, 64)
    sms = torch.cuda.get_device_properties(cuda_card).multi_processor_count
    n_split = decode_splits(8 * 16, 2048, sms)
    pos = n_split * SHARE_ALIGN * full - 1 + side
    share = split_share(pos, n_split)
    assert (share == SHARE_ALIGN * full) == (side <= 0)
    q, k, v = _inputs(cuda_card, shape, dtype, seed=2)
    _holds(q, k, v, pos, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 2048, 64), (16, 16, 2048, 64)],
                         ids=["bh1", "bh256"])
@pytest.mark.parametrize("pos", [0, 700, 2047])
def test_one_row_and_many_rows(cuda_card, dtype, shape, pos):
    q, k, v = _inputs(cuda_card, shape, dtype, seed=3)
    _holds(q, k, v, pos, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [8, 32, 64, 128])
@pytest.mark.parametrize("pos", [5, 300, 511])
def test_head_dims(cuda_card, dtype, D, pos):
    q, k, v = _inputs(cuda_card, (2, 4, 512, D), dtype, seed=4)
    _holds(q, k, v, pos, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 31, 32, 47, 95])
def test_short_cache(cuda_card, dtype, pos):
    q, k, v = _inputs(cuda_card, (2, 3, 96, 64), dtype, seed=5)
    _holds(q, k, v, pos, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 100, 543, 2046])
def test_nothing_past_pos_is_read(cuda_card, dtype, pos):
    """Every cache row past pos holds NaN: the output stays finite and
    equals the plain version's on the cache without them."""
    q, k, v = _inputs(cuda_card, (8, 16, 2048, 64), dtype, seed=6)
    want = decode_attention_plain(q, k, v, pos, 128)
    k[:, :, pos + 1:] = float("nan")
    v[:, :, pos + 1:] = float("nan")
    got = decode_attention(q, k, v, pos, 128)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_repeated_calls_reuse_the_counters(cuda_card):
    """The per-row counters are left at zero by every call, so a second
    call on the same stream combines as the first did, and on another
    stream too."""
    q, k, v = _inputs(cuda_card, (8, 16, 2048, 64), torch.float32, seed=7)
    first = _holds(q, k, v, 900, 128)
    for _ in range(3):
        torch.testing.assert_close(decode_attention(q, k, v, 900, 128), first,
                                   rtol=0, atol=0)
    side = torch.cuda.Stream(cuda_card)
    with torch.cuda.stream(side):
        other = decode_attention(q, k, v, 900, 128)
    side.synchronize()
    torch.testing.assert_close(other, first, rtol=0, atol=0)


# one position per batch entry (the continuous engine's slots): the main
# path's slot positions at the base shape
SLOT_POS = [0, 17, 130, 543, 1023, 1500, 2000, 2047]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_slot_pos_matches_plain(cuda_card, dtype):
    q, k, v = _inputs(cuda_card, (8, 16, 2048, 64), dtype, seed=8)
    pos = torch.tensor(SLOT_POS, dtype=torch.int32, device=cuda_card)
    got = _holds(q, k, v, pos, 128)
    # each slot equals the kernel run on that slot alone at its position
    for b, p in enumerate(SLOT_POS):
        one = decode_attention(q[b:b + 1].contiguous(),
                               k[b:b + 1].contiguous(),
                               v[b:b + 1].contiguous(), p, 128)
        torch.testing.assert_close(got[b:b + 1], one, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_slot_nothing_past_each_pos_is_read(cuda_card, dtype):
    q, k, v = _inputs(cuda_card, (8, 16, 2048, 64), dtype, seed=9)
    pos = torch.tensor(SLOT_POS, dtype=torch.int32, device=cuda_card)
    want = decode_attention_plain(q, k, v, pos, 128)
    for b, p in enumerate(SLOT_POS):
        k[b, :, p + 1:] = float("nan")
        v[b, :, p + 1:] = float("nan")
    got = decode_attention(q, k, v, pos, 128)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_per_slot_pos_one_slot_and_errors(cuda_card):
    q, k, v = _inputs(cuda_card, (1, 4, 256, 32), torch.float32, seed=10)
    pos = torch.tensor([77], dtype=torch.int32, device=cuda_card)
    _holds(q, k, v, pos, 128)
    q, k, v = _inputs(cuda_card, (3, 4, 256, 32), torch.float32, seed=11)
    with pytest.raises(ValueError, match="int32 vector"):
        decode_attention(q, k, v, torch.zeros(2, dtype=torch.int32,
                                              device=cuda_card), 128)
    with pytest.raises(ValueError, match="int32 vector"):
        decode_attention(q, k, v, torch.zeros(3, dtype=torch.int64,
                                              device=cuda_card), 128)
