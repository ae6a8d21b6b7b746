"""The observability plane on the card (marker ``cuda``; skips without a
card). This file needs neither JAX nor nnstreamer_tpu, so it runs where
they are not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_obs_cuda.py

* the quality reduce on a CUDA tensor equals the host reduce
  (``_reduce_np``) of the same tensor pulled afterwards — counts and
  histogram exact, float32 moments within 1e-5 of the sum of |v| (sum)
  and rtol 1e-5 (sum of squares); in bfloat16 it equals the same reduce
  on the CPU copy, moments within one bfloat16 step;
* a sampled tap pulls 73 scalars (584 bytes), never the tensor, and says
  so to the transfer ledger (``NNS_XFERCHECK``);
* ``sample_devices`` reports cuda:0's total memory and live bytes;
* the torch backend measures its first invoke's bytes on the card."""
import math

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.backends.base import Accelerator, FilterProperties
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.obs import memory as tmemory
from nnstreamer_tpu_torch.obs import quality as tquality


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _values(seed=0, n=200000):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(n)
         * rng.choice([1e-6, 1e-3, 1.0, 30.0, 1e4], n)).astype(np.float32)
    a[:7] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-10, 2.0 ** -13]
    return a


def _near_power(v):
    v = np.abs(v.astype(np.float64))
    return np.abs(v / 2.0 ** np.round(np.log2(v)) - 1) < 3 * 2.0 ** -23


@pytest.mark.cuda
def test_card_reduce_equals_host_reduce_f32(cuda_card):
    a = _values()
    got = tquality._reduce_any(torch.from_numpy(a).to(cuda_card))
    want = tquality._reduce_np(a)
    assert got[0] == want[0]
    assert (got[1] == want[1]).all()
    if not (got[3] == want[3]).all():
        # only a value within two ulps of a power of two may land in the
        # neighbouring bucket (log2f vs numpy's log2 rounding)
        live = np.abs(a[np.isfinite(a)])
        live = live[live > tquality.MIN_VALUE]
        card = torch.ceil(torch.log2(torch.from_numpy(live).to(cuda_card)))
        host = np.ceil(np.log2(live))
        differ = live[card.cpu().numpy() != host]
        assert _near_power(differ).all(), differ
    fin = np.abs(a[np.isfinite(a)].astype(np.float64)).sum()
    assert abs(got[2][0] - want[2][0]) <= 1e-5 * fin
    assert got[2][1] == pytest.approx(want[2][1], rel=1e-5)
    assert got[2][2] == want[2][2] and got[2][3] == want[2][3]


@pytest.mark.cuda
def test_card_reduce_bf16_equals_cpu_reduce(cuda_card):
    x = torch.from_numpy(_values(1)).to(torch.bfloat16)
    card = tquality._torch_reduce(x.to(cuda_card)).cpu().numpy()
    cpu = tquality._torch_reduce(x).numpy()
    assert (card[:5] == cpu[:5]).all()
    assert (card[9:] == cpu[9:]).all()
    assert card[7] == cpu[7] and card[8] == cpu[8]
    for i in (5, 6):
        step = 2.0 ** math.ceil(math.log2(abs(cpu[i]) or 1.0)) / 128
        assert abs(card[i] - cpu[i]) <= step


@pytest.mark.cuda
def test_tap_pulls_scalars_not_the_tensor(cuda_card):
    tsan.enable_xfercheck()
    try:
        acc = tquality.QualityAccountant()
        acc.observe("p:edge", [torch.randn(64, 1001, device=cuda_card)])
        rows = [r for r in tsan.xfer_transfers()
                if r["stage"] == "quality:reduce"]
    finally:
        tsan.disable_xfercheck()
        tsan.reset_xfercheck()
    assert rows == [{**rows[0], "bytes": tquality.REDUCE_PULL_BYTES,
                     "count": 1, "direction": "d2h"}]
    assert tquality.REDUCE_PULL_BYTES <= 1024
    assert acc.stages()["p:edge"]["elems"] == 64 * 1001


@pytest.mark.cuda
def test_sample_devices_reads_the_card(cuda_card):
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_card)
    rows = tmemory.sample_devices()
    row = next(r for r in rows if r["device"] == "cuda:0")
    free, total = torch.cuda.mem_get_info(0)
    assert row["budget_bytes"] == total
    assert row["bytes_in_use"] >= keep.numel()
    assert row["peak_bytes"] >= row["bytes_in_use"]
    assert 0.0 < row["used_fraction"] < 1.0
    assert tmemory.used_fraction() >= row["used_fraction"]


@pytest.mark.cuda
def test_backend_measures_the_first_invoke(cuda_card):
    be = TorchBackend()
    be.open(FilterProperties(model="builtin://matmul?n=512",
                             accelerator=Accelerator.GPU))
    x = np.ones((256, 512), np.float32)
    be.invoke([x])  # weights made and cached on this first call
    be.measure_next_invoke()
    out = be.invoke([x])
    rec = be.memory_analysis([x])
    assert rec.output_size_in_bytes == out[0].numel() * 4 == 256 * 512 * 4
    assert rec.argument_size_in_bytes == x.nbytes
    assert rec.temp_size_in_bytes >= rec.output_size_in_bytes
    assert rec.generated_code_size_in_bytes == 0
    be.close()
