"""Single-token cached-decode attention: the CUDA kernel, its wrapper, and
its plain PyTorch version.

The KV-cache decode step is the LM serving hot op: one query token attends
against the whole cache prefix — memory-bound, no reuse. The kernel
(``csrc/decode_attention.cu``) replaces nnstreamer_tpu's Pallas kernel
(``ops/pallas_decode.py::cached_decode_attention``): it streams K/V tiles of
``block_k`` keys once with the online-softmax recurrence and reads only the
tiles that hold positions ``<= pos``. Its header gives the bound on the card
and its design.

``decode_attention`` is the wrapper. On CPU tensors it runs
``decode_attention_plain``, the same function in PyTorch ops (masked
scores, softmax, weighted sum, in f32) — the version the tests hold against
the Pallas kernel. On CUDA tensors it launches the kernel or raises; it
never gives way to the plain version there. ``decode_attention.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from .build import load_kernel

MAX_HEAD_DIM = 256   # the kernel's 256 threads cover the head dimension
MAX_BLOCK_K = 8192   # a tile's scores live in (static-size) shared memory

Pos = Union[int, torch.Tensor]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           block_k: int) -> int:
    """Validate shapes and types; return the effective block_k."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, H, 1, D), got {tuple(q.shape)}")
    B, H, _, D = q.shape
    if k.dim() != 4 or tuple(k.shape[:2]) != (B, H) or k.shape[3] != D:
        raise ValueError(
            f"k must be (B, H, T, D) = ({B}, {H}, T, {D}), got {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if q.dtype is not torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype is not k.dtype:
        raise TypeError(
            f"k/v must both be float32 or both bfloat16, got {k.dtype}/{v.dtype}")
    T = k.shape[2]
    block_k = min(block_k, T)
    if block_k < 1 or T % block_k:
        raise ValueError(
            f"block_k {block_k} must divide the cache length {T}")
    return block_k


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: Pos, block_k: int = 128) -> torch.Tensor:
    """The same function in PyTorch ops: positions ``<= pos`` are attended.
    ``pos`` is an int or a 1-element integer tensor. ``block_k`` only
    validates the cache length, as the kernel requires."""
    _check(q, k, v, block_k)
    D, T = q.shape[3], k.shape[2]
    scale = 1.0 / (D ** 0.5)
    s = (q.float() * scale) @ k.float().transpose(-1, -2)     # (B, H, 1, T)
    visible = torch.arange(T, device=q.device) <= pos
    s = s.masked_fill(~visible, -1e30)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _pos_tensor(pos: Pos, device: torch.device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype is not torch.int32 \
                or pos.device != device:
            raise ValueError(
                f"pos must be one int32 on {device}, got {pos.dtype} "
                f"{tuple(pos.shape)} on {pos.device}")
        return pos
    # a fill kernel with the value as its argument: no host-to-device copy
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


@functools.cache
def _kernel():
    """The kernel's C entry point with its argument types (built on first
    use)."""
    fn = load_kernel("decode_attention").nns_decode_attention
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Pos, block_k: int = 128) -> torch.Tensor:
    """One-token attention against a cache prefix.

    q: (B, H, 1, D) float32; k/v: (B, H, T, D) float32 or bfloat16 caches;
    ``pos``: positions ``<= pos`` are attended (cache[pos] holds the current
    token's K/V, already written) — an int, or one int32 on q's device.
    Returns (B, H, 1, D) float32. ``block_k`` must divide T.
    """
    block_k = _check(q, k, v, block_k)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return decode_attention_plain(q, k, v, pos, block_k)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"decode_attention needs q, k, v on one CUDA device or all on "
            f"the CPU, got {sorted(map(str, devices))}")
    B, H, _, D = q.shape
    T = k.shape[2]
    if D > MAX_HEAD_DIM or block_k > MAX_BLOCK_K:
        raise ValueError(
            f"head dim {D} > {MAX_HEAD_DIM} or block_k {block_k} > "
            f"{MAX_BLOCK_K} is not supported by the kernel")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q, k and v")
    pos_t = _pos_tensor(pos, q.device)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
                 out.data_ptr(), B * H, T, D, block_k,
                 int(k.dtype is torch.bfloat16), 1.0 / (D ** 0.5), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
