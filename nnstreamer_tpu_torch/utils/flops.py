"""FLOPs accounting and MFU: model FLOP/s against the card's peak.

The port of nnstreamer_tpu's ``utils/flops.py``. A raw rate says nothing
about how much of the card a run uses, so a benchmark also reports model
FLOP/s and MFU (model FLOPs / the card's peak FLOPs). Model FLOPs come
from PyTorch's own count of one call (``torch.utils.flop_counter``), or
from the analytic transformer estimate; the peak from a table of NVIDIA's
published H100 figures keyed on the card's name.

The peaks are the vendor's data-sheet figures, dense (the sparsity
figures halved), at the card's full power limit — a specification, not a
measurement: a card capped below it (``nvidia-smi``'s ``power.limit``)
runs slower under load. On the CPU, or a card the table does not know,
the peak is None and so is the MFU; the FLOP counts still flow.

``compiled_flops`` counts the aten operators a call runs. The package's
hand-written kernels are launched through ``ctypes`` and are not aten
operators, so their work is not in the count (the attention of the
serving path; the training step has none).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

# NVIDIA H100 data sheets, dense FLOP/s by type. First substring match on
# the lowercased device name wins, so the NVL and PCIe parts come before
# the SXM names. "float32" is the non-tensor-core rate; int8 is TOP/s.
_PEAKS: Tuple[Tuple[str, Dict[str, float]], ...] = (
    ("h100 nvl", {"float32": 60e12, "tf32": 417.5e12, "bfloat16": 835.5e12,
                  "float16": 835.5e12, "float8": 1670.5e12,
                  "int8": 1670.5e12}),
    ("h100 pcie", {"float32": 51e12, "tf32": 378e12, "bfloat16": 756.5e12,
                   "float16": 756.5e12, "float8": 1513e12,
                   "int8": 1513e12}),
    ("h100 80gb hbm3", {"float32": 66.9e12, "tf32": 494.7e12,
                        "bfloat16": 989.4e12, "float16": 989.4e12,
                        "float8": 1978.9e12, "int8": 1978.9e12}),
    ("h100 sxm", {"float32": 66.9e12, "tf32": 494.7e12,
                  "bfloat16": 989.4e12, "float16": 989.4e12,
                  "float8": 1978.9e12, "int8": 1978.9e12}),
)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.float8_e4m3fn: "float8", torch.float8_e5m2: "float8"}

DType = Union[str, torch.dtype]


def _dtype_name(dtype: DType) -> str:
    name = _DTYPE_NAMES.get(dtype, dtype) if isinstance(dtype, torch.dtype) \
        else dtype
    if not isinstance(name, str) or name not in _PEAKS[0][1]:
        raise ValueError(f"no peak is kept for dtype {dtype!r} (one of "
                         f"{sorted(_PEAKS[0][1])})")
    return name


def peak_flops_for_name(name: str, dtype: DType = "bfloat16"
                        ) -> Optional[float]:
    """The data sheet's dense peak FLOP/s for a card named ``name``
    (``torch.cuda.get_device_name``) in ``dtype`` ("float32" off the
    tensor cores, "tf32", "bfloat16", "float16", "float8", "int8", or a
    torch dtype); None for a card the table does not know."""
    key = _dtype_name(dtype)
    low = name.lower()
    for part, peaks in _PEAKS:
        if part in low:
            return peaks[key]
    return None


def peak_flops_per_chip(device=None, dtype: DType = "bfloat16"
                        ) -> Optional[float]:
    """Peak dense FLOP/s of ``device`` (default: the card, ``cuda:0``) in
    ``dtype``; None on the CPU, when there is no card, or for a card the
    table does not know."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device) if not isinstance(device, int) \
        else torch.device("cuda", device)
    if device.type != "cuda":
        return None
    return peak_flops_for_name(torch.cuda.get_device_name(device), dtype)


def compiled_flops(fn, *example_args, **example_kwargs) -> Optional[float]:
    """FLOPs of one call of ``fn(*example_args)``, as PyTorch's
    ``FlopCounterMode`` counts its aten operators (matrix products,
    convolutions, attention; hand-written kernels are not counted). The
    call runs once, on the arguments' device; an error in it is raised.
    None when it counts nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args, **example_kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def transformer_flops(n_params: int, n_layers: int, d_model: int,
                      seq_len: int, n_tokens: int,
                      kv_cache_len: int = 0) -> float:
    """Analytic decoder-transformer FLOPs for ``n_tokens`` processed
    tokens: 2·N·tokens for the matrix products plus 12·L·D·tokens·ctx for
    the attention scores (dominant only at long context).
    ``kv_cache_len``: the context each token attends in cached decode (0
    = full causal, seq_len/2 on average)."""
    ctx = kv_cache_len if kv_cache_len > 0 else max(seq_len, 1) / 2.0
    matmul = 2.0 * n_params * n_tokens
    attn = 12.0 * n_layers * d_model * n_tokens * ctx
    return matmul + attn


def mfu(flops_per_second: Optional[float], n_chips: int = 1, device=None,
        dtype: DType = "bfloat16") -> Optional[float]:
    """Model FLOP utilization in [0, 1] against the ``dtype`` peak; None
    when either side is unknown."""
    if not flops_per_second:
        return None
    peak = peak_flops_per_chip(device, dtype)
    if not peak:
        return None
    return flops_per_second / (peak * max(n_chips, 1))


def count_params(params: Any) -> int:
    """Total scalar count of a tree (dicts, lists, tuples) of tensors or
    arrays."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    if isinstance(params, torch.Tensor):
        return int(params.numel())
    return int(getattr(params, "size", 0))


def bench_mesh_policy(n_devices: int, on_cpu: bool, batch: int):
    """The mesh policy a multi-card benchmark shares: mesh the model stage
    over every card unless ``BENCH_NO_MESH``, with ``BENCH_FORCE_MESH``
    turning it on for a CPU world. Returns ``(mesh_custom, batch)`` —
    the batch rounded up to a multiple of the dp axis, because an
    indivisible batch runs whole on every rank and the reported MFU would
    claim cards that did no work of their own."""
    if n_devices <= 1 or os.environ.get("BENCH_NO_MESH") \
            or (on_cpu and not os.environ.get("BENCH_FORCE_MESH")):
        return "", batch
    if batch % n_devices:
        batch = ((batch + n_devices - 1) // n_devices) * n_devices
    return "mesh:auto", batch


def perf_record(flops_per_item: Optional[float], items_per_second: float,
                n_chips: int = 1, device=None,
                dtype: DType = "bfloat16") -> dict:
    """The fields every benchmark row carries: model_tflops_per_s and
    mfu (None where unknown)."""
    if not flops_per_item or items_per_second <= 0:
        return {"model_tflops_per_s": None, "mfu": None}
    rate = flops_per_item * items_per_second
    u = mfu(rate, n_chips=n_chips, device=device, dtype=dtype)
    return {"model_tflops_per_s": round(rate / 1e12, 4),
            "mfu": round(u, 4) if u is not None else None}
