"""Exact attention over a whole sequence: the CUDA kernel, its wrapper, and
its plain PyTorch version.

The prompt prefill's causal self-attention is the one place the serving
path attends a whole sequence to itself. The kernel
(``csrc/flash_attention.cu``) replaces nnstreamer_tpu's Pallas kernel
(``ops/pallas_attention.py::flash_attention``): it walks K/V tiles with the
online-softmax recurrence in f32, stops at the diagonal under the causal
mask, and never writes the S x S scores to device memory. Its products run
on the tensor cores (``mma.sync``): bf16 products for bf16 inputs, and
three TF32 products per f32 product (3xTF32) for f32 inputs, which keeps
f32 accuracy. Its header gives the bound on the card and its design.

``flash_attention`` is the wrapper and keeps the JAX contract: ``block_q``
and ``block_k`` are each clipped to S and must divide it, else
``ValueError``. They are the contract, not the kernel's tiling, which is
its own. On CPU tensors it runs ``flash_attention_plain``, the same function
in PyTorch ops (masked dense softmax in f32) — the version the tests hold
against the Pallas kernel. On CUDA tensors it launches the kernel or
raises; it never gives way to the plain version there.
``flash_attention.launches`` counts kernel launches.

The same body is the torch op ``nns::flash_attention``, with a fake
implementation for shapes: under a ``torch.export`` trace the wrapper
emits that op, so an exported program holds one node per call and its
loaded module launches the kernel (``aot/``); eager callers call the body
directly, past the op dispatcher's host cost.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel

HEAD_DIMS = (8, 16, 32, 64, 128)   # the head dims the kernel is built for


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_q: int, block_k: int) -> None:
    """Validate shapes and types and the block contract."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must have one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype.is_floating_point and k.dtype is q.dtype
            and v.dtype is q.dtype):
        raise TypeError(f"q, k, v must share one float dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    S = q.shape[2]
    block_q, block_k = min(block_q, S), min(block_k, S)
    if block_q < 1 or block_k < 1 or S % block_q or S % block_k:
        raise ValueError(f"block sizes ({block_q}, {block_k}) must divide "
                         f"seq {S}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """The same function in PyTorch ops: scores in f32, masked (k_pos <=
    q_pos) when ``causal``, softmax, weighted sum; returns q's dtype. The
    blocks only validate S, as the kernel's contract requires."""
    _check(q, k, v, block_q, block_k)
    S, D = q.shape[2], q.shape[3]
    s = (q.float() * (1.0 / D ** 0.5)) @ k.float().transpose(-1, -2)
    if causal:
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
        s = s.masked_fill(~mask, -1e30)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


@functools.cache
def _kernel():
    """The kernel's C entry point with its argument types (built on first
    use)."""
    fn = load_kernel("flash_attention").nns_flash_attention
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Exact attention. q/k/v: (B, H, S, D) → (B, H, S, D) in q's dtype.

    On the card q, k, v must be contiguous and 16-byte aligned, all
    float32 or all bfloat16, with D in ``HEAD_DIMS``. ``causal`` masks
    k_pos > q_pos. Under a trace (``torch.export``) it emits the
    ``nns::flash_attention`` op.
    """
    if torch.compiler.is_compiling():
        return flash_attention_op(q, k, v, causal, block_q, block_k)
    return _flash_attention(q, k, v, causal, block_q, block_k)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, block_q: int,
                     block_k: int) -> torch.Tensor:
    _check(q, k, v, block_q, block_k)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal, block_q, block_k)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device or all on "
            f"the CPU, got {sorted(map(str, devices))}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B * H, S, D, int(causal), int(q.dtype is torch.bfloat16),
                 1.0 / (D ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


@torch.library.custom_op("nns::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, block_q: int,
                       block_k: int) -> torch.Tensor:
    """:func:`flash_attention` as a torch op."""
    return _flash_attention(q, k, v, causal, block_q, block_k)


@flash_attention_op.register_fake
def _(q, k, v, causal, block_q, block_k):
    _check(q, k, v, block_q, block_k)
    return torch.empty_like(q)
