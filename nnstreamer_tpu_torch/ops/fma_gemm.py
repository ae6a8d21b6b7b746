"""Sequential-FMA float32 GEMM: the CUDA kernel, its wrapper and its plain
PyTorch version.

``out[m, n] = fmaf(a[m, K-1], b[K-1, n], ... fmaf(a[m, 0], b[0, n], 0))``:
one float32 fused multiply-add per step of K, in K's order. For some conv
shapes XLA:CPU's ``precision=HIGHEST`` float32 conv (the reference
importer's) sums in exactly this order, so a quantized graph's fake-quant
simulation run this way snaps every value to the same step as the
reference (``models/tflite_import.py::FMA_ORDERS`` lists the shapes).

``fma_gemm`` is the wrapper. On CPU tensors it runs ``fma_gemm_plain``: each
step is a float64 product (exact for two float32 factors) and sum, rounded
to float32. Rounding twice differs from rounding once only where the
float64 sum is inexact and lies on a float32 midpoint (or in float32's
subnormal range); there the step is redone exactly, rounding to odd with a
two-sum error term, which is the correctly rounded ``fmaf`` (53 bits
carry more than the 24 + 2 that rounding to odd needs). On the CPU the
rows go in blocks that stay in cache. On CUDA tensors it launches
``csrc/fma_gemm.cu`` (persistent blocks over M x N tiles fed by a
``cp.async`` ring of A and B slabs, each output's ``fmaf`` chain over K in
order in one thread's registers; ``tile_for`` names the tile it picks for
a shape; ``padded_rows`` lays rows out on the pitch its 16-byte copies
take) or raises; ``fma_gemm.launches`` counts the launches. The plain
version runs on the card as well, bit-equal to the kernel.

``chains`` 2 or 4 and ``kblock`` are the orders XLA:CPU takes at other
shapes (each listed shape's order is in
``models/tflite_import.py::FMA_ORDERS``): ``chains`` such chains per
output, chain c over k = c, c + chains, ..., summed pairwise in float32,
``c0 + c1`` or ``(c0 + c1) + (c2 + c3)``; or (``kblock``, a multiple of
32, with one chain) a chain over each block of ``kblock`` steps of K, the
blocks' sums added in order.
"""
from __future__ import annotations

import ctypes
import functools
import math

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


def _fma_step(x: torch.Tensor, acc: torch.Tensor,
              screen: bool = True) -> torch.Tensor:
    """float64 ``x + acc`` (``x`` exact, ``acc`` float32 values) rounded
    as one float32 FMA would, returned in float64. ``screen``: look for
    the sums that rounding twice can get wrong first, and redo the step
    only where there are any; without it every step is redone (cheaper
    where most blocks have some, as in sums of quantized activations)."""
    s = x + acc
    bits = s.view(torch.int64)
    if screen:
        low, exp = bits & _LOW29, bits & _EXP
        # any suspect, by two integer minima (comparisons cost more here)
        if not (s.numel() and (int((low ^ _HALF29).min()) == 0
                               or int(exp.min()) < _F32_NORMAL)):
            return s.float().double()
    # round to odd over the whole block: an inexact sum with an even last
    # bit moves one ulp toward the exact value, +1 on its bits where err
    # and s have one sign, -1 where they differ (sign(err) is 0 on an
    # exact sum). Rounded to odd in float64 and then to nearest in
    # float32, a sum is rounded once (53 >= 24 + 2 bits).
    bb = s - x
    err = (x - (s - bb)) + (acc - bb)            # s + err == x + acc exactly
    step = ((torch.sign(err) * torch.sign(s)).to(torch.int64)
            * (1 - (bits & 1)))
    return (bits + step).view(torch.float64).float().double()


def _check_order(chains: int, kblock: int) -> None:
    if chains not in CHAINS:
        raise ValueError(f"fma_gemm: chains must be one of {CHAINS}, "
                         f"got {chains}")
    if kblock < 0 or kblock % 32 or (kblock and chains != 1):
        raise ValueError(f"fma_gemm: kblock {kblock} must be 0 or a "
                         "multiple of 32, with one chain")


CHAINS = (1, 2, 4)


def fmaf(x: torch.Tensor, s: float, y: torch.Tensor) -> torch.Tensor:
    """Elementwise float32 ``fmaf(x, s, y)``, rounded once, of float32
    tensors ``x`` and ``y`` and a float32 value ``s``, on any device: the
    float64 product of two float32 values is exact, and the sum is rounded
    to odd before float32 (``_fma_step`` unscreened, so no value is read
    back to the host and a CUDA graph can capture it)."""
    return _fma_step(x.double() * s, y.double(), screen=False).float()


def fma_gemm_plain(a: torch.Tensor, b: torch.Tensor, chains: int = 1,
                   kblock: int = 0) -> torch.Tensor:
    """``a @ b`` as ``chains`` chains of correctly rounded float32 FMAs
    over K (chain c over k ≡ c mod ``chains``), summed pairwise; or, with
    ``kblock``, one chain a block of K, the blocks summed in order."""
    _check(a, b)
    _check_order(chains, kblock)
    if kblock and b.shape[0] > kblock:
        K = b.shape[0]
        out = fma_gemm_plain(a[..., :kblock], b[:kblock])
        for k0 in range(kblock, K, kblock):
            out = out + fma_gemm_plain(a[..., k0:k0 + kblock],
                                       b[k0:k0 + kblock])
        return out
    if chains > 1:
        parts = [fma_gemm_plain(a[..., c::chains], b[c::chains])
                 for c in range(chains)]
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
        return parts[0]
    K, N = b.shape
    a2 = a.reshape(math.prod(a.shape[:-1]), K)   # K may be 0 (a short chain)
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
    lib = load_kernel("fma_gemm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.nns_fma_gemm.argtypes = [vp, vp, vp, i, i, i, ll, ll, i, i, i, vp]
    lib.nns_fma_gemm.restype = i
    lib.nns_fma_gemm_config.argtypes = [i, i, i, i, i, i]
    lib.nns_fma_gemm_config.restype = i
    lib.nns_fma_gemm_describe.argtypes = [i, ctypes.POINTER(i)]
    lib.nns_fma_gemm_describe.restype = i
    return lib


_TILE_FIELDS = ("bm", "bn", "tm", "tn", "chains", "split", "kblocks",
                "stages", "threads")


def tile_table() -> list:
    """The kernel's tiles (``_TILE_FIELDS`` each), in its table's order."""
    lib = _kernel()
    shape = (ctypes.c_int * len(_TILE_FIELDS))()
    n = lib.nns_fma_gemm_describe(0, shape)
    out = []
    for i in range(n):
        lib.nns_fma_gemm_describe(i, shape)
        out.append(dict(zip(_TILE_FIELDS, shape)))
    return out


def tile_for(m: int, k: int, n: int, chains: int = 1, kblock: int = 0,
             device=None) -> dict:
    """The tile the kernel runs an (m, k) x (k, n) product in, in the
    given order, on the current (or given) CUDA device: its index in
    :func:`tile_table` and its fields."""
    lib = _kernel()
    with torch.cuda.device(device):
        idx = lib.nns_fma_gemm_config(m, k, n, chains, kblock, -1)
    if idx < 0:
        raise ValueError(f"fma_gemm: no tile for ({m}, {k}) x ({k}, {n}), "
                         f"{chains} chains, blocks of {kblock}")
    return {"index": idx, **tile_table()[idx]}


def _rows(x: torch.Tensor):
    """``x`` (rows, cols) and its row pitch for the kernel: rows of unit
    stride are read where they lie (a channel slice, a padded pitch) if
    the storage holds each row's floats up to its next multiple of 4 (the
    kernel's 16-byte copies read that far); anything else is copied
    dense."""
    rows, cols = x.shape
    if rows > 1 and cols and x.stride(-1) == 1 and x.stride(0) >= cols:
        pitch = x.stride(0)
        end = x.storage_offset() + (rows - 1) * pitch + -(-cols // 4) * 4
        if pitch % 4 or end * 4 <= x.untyped_storage().nbytes():
            return x, pitch
    x = x.contiguous()
    return x, cols


def fma_gemm(a: torch.Tensor, b: torch.Tensor, chains: int = 1,
             kblock: int = 0) -> torch.Tensor:
    """a (..., K) float32 times b (K, N) float32 → (..., N) float32, summed
    over K in order by fused multiply-adds, in ``chains`` chains or blocks
    of ``kblock`` (module docstring)."""
    _check(a, b)
    _check_order(chains, kblock)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return fma_gemm_plain(a, b, chains, kblock)
    if a.device.type == "meta":  # shape tracing
        return a.new_empty(a.shape[:-1] + (b.shape[1],))
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"fma_gemm needs a and b on one CUDA device or both "
                         f"on the CPU, got {a.device} and {b.device}")
    K, N = b.shape
    # K may be 0 (a short chain), so the row count is not left to -1.
    a2, lda = _rows(a.reshape(math.prod(a.shape[:-1]), K))
    b2, ldb = _rows(b)
    out = torch.empty(a2.shape[0], N, dtype=torch.float32, device=a.device)
    if out.numel():
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _kernel().nns_fma_gemm(
                a2.data_ptr(), b2.data_ptr(), out.data_ptr(), a2.shape[0], K,
                N, lda, ldb, chains, kblock, -1, stream)
        if err:
            raise RuntimeError(
                f"fma_gemm kernel launch failed: CUDA error {err}")
        fma_gemm.launches += 1
    return out.reshape(a.shape[:-1] + (N,))


fma_gemm.launches = 0


def padded_rows(rows: int, k: int, device) -> torch.Tensor:
    """An uninitialised (rows, k) float32 view whose rows lie a multiple of
    4 floats apart (the kernel then copies them in 16-byte runs, whatever
    k is; the floats past k are never a step of a chain)."""
    pitch = -(-k // 4) * 4
    return torch.empty(rows, pitch, dtype=torch.float32,
                       device=device)[:, :k]
