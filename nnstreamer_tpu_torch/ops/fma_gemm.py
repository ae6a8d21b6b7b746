"""Sequential-FMA float32 GEMM: the CUDA kernel, its wrapper and its plain
PyTorch version.

``out[m, n] = fmaf(a[m, K-1], b[K-1, n], ... fmaf(a[m, 0], b[0, n], 0))``:
one float32 fused multiply-add per step of K, in K's order. For some conv
shapes XLA:CPU's ``precision=HIGHEST`` float32 conv (the reference
importer's) sums in exactly this order, so a quantized graph's fake-quant
simulation run this way snaps every value to the same step as the
reference (``models/tflite_import.py::FMA_ORDER_SHAPES`` lists the shapes).

``fma_gemm`` is the wrapper. On CPU tensors it runs ``fma_gemm_plain``: each
step is a float64 product (exact for two float32 factors) and sum, rounded
to float32. Rounding twice differs from rounding once only where the
float64 sum is inexact and lies on a float32 midpoint (or in float32's
subnormal range); there the step is redone exactly, rounding to odd with a
two-sum error term, which is the correctly rounded ``fmaf`` (53 bits
carry more than the 24 + 2 that rounding to odd needs). On the CPU the
rows go in blocks that stay in cache. On CUDA tensors it launches
``csrc/fma_gemm.cu`` (M x N tiles in shared memory, each output's ``fmaf``
chain over K in order in one thread's registers) or raises;
``fma_gemm.launches`` counts the launches. The plain version runs on the
card as well, bit-equal to the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype is not torch.float32 or b.dtype is not torch.float32:
        raise TypeError(f"fma_gemm needs float32, got {a.dtype}/{b.dtype}")
    if a.dim() < 1 or b.dim() != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"fma_gemm: a (..., K) and b (K, N) do not match: "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


# float64 bit fields: the 29 mantissa bits below float32's, their midpoint,
# the exponent, and the exponent of float32's smallest normal
_LOW29 = (1 << 29) - 1
_HALF29 = 1 << 28
_EXP = 0x7FF << 52
_F32_NORMAL = (1023 - 126) << 52
# elements of a CPU block (rows x N): in cache, and below the size at
# which PyTorch splits an elementwise op over threads (none spin idle)
_CPU_BLOCK = 1 << 15


def _fma_step(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float64 ``x + acc`` (``x`` exact, ``acc`` float32 values) rounded
    as one float32 FMA would, returned in float64."""
    s = x + acc
    bits = s.view(torch.int64)
    suspect = ((bits & _LOW29) == _HALF29) | ((bits & _EXP) < _F32_NORMAL)
    if bool(suspect.any()):
        xs, cs, ss = x.expand_as(s)[suspect], acc[suspect], s[suspect]
        bb = ss - xs
        err = (xs - (ss - bb)) + (cs - bb)       # ss + err == xs + cs exactly
        # round to odd: an inexact sum with an even last bit moves one ulp
        # toward the exact value (toward an infinity of err's sign: ss + err
        # rounds back to ss)
        odd = (err != 0) & ((ss.view(torch.int64) & 1) == 0)
        toward = torch.copysign(torch.full_like(ss, float("inf")), err)
        s[suspect] = torch.where(odd, torch.nextafter(ss, toward), ss)
    return s.float().double()


def fma_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a chain of correctly rounded float32 FMAs over K."""
    _check(a, b)
    K, N = b.shape
    a2 = a.reshape(-1, K)
    M = a2.shape[0]
    b64 = b.double()
    out = torch.empty(M, N, dtype=torch.float32, device=a.device)
    rows = M if a.device.type != "cpu" else max(8, _CPU_BLOCK // max(N, 1))
    for m0 in range(0, M, max(rows, 1)):
        blk = a2[m0:m0 + rows].double()
        acc = torch.zeros(blk.shape[0], N, dtype=torch.float64,
                          device=a.device)
        for k in range(K):
            acc = _fma_step(blk[:, k:k + 1] * b64[k], acc)
        out[m0:m0 + rows] = acc.float()
    return out.reshape(a.shape[:-1] + (N,))


@functools.cache
def _kernel():
    fn = load_kernel("fma_gemm").nns_fma_gemm
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def fma_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) float32 times b (K, N) float32 → (..., N) float32, summed
    over K in order by fused multiply-adds (module docstring)."""
    _check(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return fma_gemm_plain(a, b)
    if a.device.type == "meta":  # shape tracing
        return a.new_empty(a.shape[:-1] + (b.shape[1],))
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"fma_gemm needs a and b on one CUDA device or both "
                         f"on the CPU, got {a.device} and {b.device}")
    K, N = b.shape
    a2 = a.reshape(-1, K).contiguous()
    b = b.contiguous()
    out = torch.empty(a2.shape[0], N, dtype=torch.float32, device=a.device)
    if out.numel():
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _kernel()(a2.data_ptr(), b.data_ptr(), out.data_ptr(),
                            a2.shape[0], K, N, stream)
        if err:
            raise RuntimeError(
                f"fma_gemm kernel launch failed: CUDA error {err}")
        fma_gemm.launches += 1
    return out.reshape(a.shape[:-1] + (N,))


fma_gemm.launches = 0
