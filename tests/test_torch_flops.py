"""The port's FLOPs accounting and MFU (``utils/flops.py``) against
nnstreamer_tpu's (mirrors ``tests/test_flops.py``): the same output shape
from each function, the analytic estimate and the record helper equal to
the reference's, PyTorch's operator count close to the analytic product
count, the H100 peak table (NVIDIA's data sheets, dense), and None — never
a guess — on the CPU or for an unknown card.
"""
import numpy as np
import pytest
import torch

from nnstreamer_tpu.utils import flops as ref
from nnstreamer_tpu_torch.utils.flops import (
    bench_mesh_policy,
    compiled_flops,
    count_params,
    mfu,
    peak_flops_for_name,
    peak_flops_per_chip,
    perf_record,
    transformer_flops,
)


def test_compiled_flops_close_to_analytic():
    got = compiled_flops(lambda x, w: x @ w, torch.ones(8, 256),
                         torch.ones(256, 512))
    analytic = 2 * 8 * 256 * 512
    assert isinstance(got, float)
    assert analytic <= got <= analytic * 1.25
    # elementwise work only: nothing the counter counts
    assert compiled_flops(lambda x: x + 1, torch.ones(4)) is None


@pytest.mark.parametrize("name,dtype,want", [
    ("NVIDIA H100 80GB HBM3", "bfloat16", 989.4e12),
    ("NVIDIA H100 80GB HBM3", torch.float16, 989.4e12),
    ("NVIDIA H100 80GB HBM3", "tf32", 494.7e12),
    ("NVIDIA H100 80GB HBM3", torch.float32, 66.9e12),
    ("NVIDIA H100 80GB HBM3", "float8", 1978.9e12),
    ("NVIDIA H100 PCIe", "bfloat16", 756.5e12),
    ("NVIDIA H100 NVL", "bfloat16", 835.5e12),
    ("NVIDIA A100-SXM4-80GB", "bfloat16", None),
])
def test_peak_table(name, dtype, want):
    assert peak_flops_for_name(name, dtype) == want


def test_peak_is_none_on_the_cpu_and_unknown_dtypes_raise():
    assert peak_flops_per_chip("cpu") is None
    assert peak_flops_per_chip(torch.device("cpu"), "float32") is None
    with pytest.raises(ValueError, match="no peak"):
        peak_flops_for_name("NVIDIA H100 80GB HBM3", torch.int32)


def test_mfu_and_record(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    dev = torch.device("cuda", 0)
    assert mfu(98.94e12, device=dev) == pytest.approx(0.1)
    assert mfu(6.69e12, device=dev, dtype="float32") == pytest.approx(0.1)
    rec = perf_record(1e9, 1000.0, device=dev)
    assert set(rec) == {"model_tflops_per_s", "mfu"}
    assert rec["model_tflops_per_s"] == pytest.approx(1.0)
    assert rec["mfu"] == pytest.approx(1e12 / 989.4e12, abs=5e-5)
    # the CPU: the rate flows, the MFU is unknown — as the reference's
    got = perf_record(1e9, 1000.0, device="cpu")
    want = ref.perf_record(1e9, 1000.0, device=type(
        "D", (), {"platform": "cpu", "device_kind": "cpu"})())
    assert got == want == {"model_tflops_per_s": 1.0, "mfu": None}
    assert perf_record(None, 1000.0) == ref.perf_record(None, 1000.0) == {
        "model_tflops_per_s": None, "mfu": None}
    assert mfu(None) is None and ref.mfu(None) is None


@pytest.mark.parametrize("kw", [
    dict(n_params=125_000_000, n_layers=12, d_model=768, seq_len=64,
         n_tokens=1024),
    dict(n_params=186_000_000, n_layers=12, d_model=1024, seq_len=512,
         n_tokens=4096, kv_cache_len=543),
])
def test_transformer_flops_equals_the_reference(kw):
    got = transformer_flops(**kw)
    assert got == ref.transformer_flops(**kw)
    assert got >= 2.0 * kw["n_params"] * kw["n_tokens"]


def test_count_params_matches_the_reference():
    tree = {"a": np.zeros((3, 4)), "b": [np.zeros(5), np.zeros((2, 2))]}
    assert count_params(tree) == ref.count_params(tree) == 21
    assert count_params({"a": torch.zeros(3, 4),
                         "b": (torch.zeros(5), [torch.zeros(2, 2)])}) == 21


@pytest.mark.parametrize("args", [(1, False, 8), (4, False, 6),
                                  (4, True, 6), (8, False, 64)])
def test_bench_mesh_policy_matches_the_reference(args, monkeypatch):
    monkeypatch.delenv("BENCH_NO_MESH", raising=False)
    monkeypatch.delenv("BENCH_FORCE_MESH", raising=False)
    assert bench_mesh_policy(*args) == ref.bench_mesh_policy(*args)
    monkeypatch.setenv("BENCH_FORCE_MESH", "1")
    assert bench_mesh_policy(*args) == ref.bench_mesh_policy(*args)
    monkeypatch.setenv("BENCH_NO_MESH", "1")
    assert bench_mesh_policy(*args) == ("", args[2])
