"""Single-token cached-decode attention: the CUDA kernel, its wrapper, and
its plain PyTorch version.

The KV-cache decode step is the LM serving hot op: one query token attends
against the whole cache prefix — memory-bound, no reuse. The kernel
(``csrc/decode_attention.cu``) replaces nnstreamer_tpu's Pallas kernel
(``ops/pallas_decode.py::cached_decode_attention``). It splits the visible
prefix ``[0, pos]`` of each (b, h) over ``n_split`` blocks
(``decode_splits``), streams each block's K and V rows through a
shared-memory ring with asynchronous copies, and combines the blocks'
partial softmax results in the last block of each (b, h). Its header gives
the bound on the card and the design.

``pos`` is one position for the whole batch (an int, or one int32 on the
device) or one per batch entry (a ``(B,)`` int32 tensor on q's device, the
continuous engine's slots): row (b, h) attends ``[0, pos[b]]``.

``decode_attention`` is the wrapper. On CPU tensors it runs
``decode_attention_plain``, the same function in PyTorch ops (masked
scores, softmax, weighted sum, in f32) — the version the tests hold against
the Pallas kernel. On CUDA tensors it launches the kernel or raises; it
never gives way to the plain version there. ``decode_attention.launches``
counts calls that launched the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple, Union

import torch

from .build import load_kernel

HEAD_DIMS = (8, 16, 32, 64, 128)   # the head dims the kernel is built for
# n_split: about this many blocks per SM over all (b, h) rows, each share at
# least SHARE_ALIGN keys and at most MAX_SHARE (its scores sit in shared
# memory). The kernel rounds a share up to a multiple of SHARE_ALIGN.
BLOCKS_PER_SM = 6
SHARE_ALIGN = 16
MAX_SHARE = 16384

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


def _pos_tensor(pos: Pos, batch: int, device: torch.device) -> torch.Tensor:
    """``pos`` as int32 on ``device``: one value, or ``batch`` values (one
    per batch entry)."""
    if isinstance(pos, torch.Tensor):
        if pos.numel() not in (1, batch) or pos.dim() > 1 \
                or pos.dtype is not torch.int32 or pos.device != device:
            raise ValueError(
                f"pos must be one int32 or a ({batch},) int32 vector on "
                f"{device}, got {pos.dtype} {tuple(pos.shape)} on "
                f"{pos.device}")
        return pos.reshape(-1)
    # a fill kernel with the value as its argument: no host-to-device copy
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: Pos, block_k: int = 128) -> torch.Tensor:
    """The same function in PyTorch ops: row (b, h) attends positions
    ``<= pos`` (or ``<= pos[b]``). ``pos`` is an int, one int32 or a
    ``(B,)`` int32 vector on q's device. ``block_k`` only validates the
    cache length, as the kernel requires."""
    _check(q, k, v, block_k)
    B, D, T = q.shape[0], q.shape[3], k.shape[2]
    scale = 1.0 / (D ** 0.5)
    s = (q.float() * scale) @ k.float().transpose(-1, -2)     # (B, H, 1, T)
    # (1 or B, T) visible positions, broadcast over heads and the query
    visible = (torch.arange(T, device=q.device)[None, :]
               <= _pos_tensor(pos, B, q.device)[:, None])
    s = s.masked_fill(~visible[:, None, None, :], -1e30)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def decode_splits(rows: int, t_len: int, sms: int) -> int:
    """Blocks per (b, h) row: fixed by the shapes and the card, never by
    ``pos``, so a captured launch replays unchanged."""
    n = min(max(1, sms * BLOCKS_PER_SM // rows), -(-t_len // SHARE_ALIGN))
    return max(n, -(-t_len // MAX_SHARE))


def split_share(pos: int, n_split: int) -> int:
    """Keys per block at ``pos``, as the kernel computes it: the boundaries
    between splits fall at multiples of this."""
    per = -(-(pos + 1) // n_split)
    return -(-per // SHARE_ALIGN) * SHARE_ALIGN


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# per (device, stream): one int32 counter per row, zero between calls (the
# last block of each row resets its own), so calls on one stream share them
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _row_counters(device: torch.device, stream: int,
                  rows: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < rows:
        c = _counters[key] = torch.zeros(rows, dtype=torch.int32,
                                         device=device)
    return c


@functools.cache
def _kernel():
    """The kernel's C entry point with its argument types (built on first
    use)."""
    fn = load_kernel("decode_attention").nns_decode_attention
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                   ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Pos, block_k: int = 128) -> torch.Tensor:
    """One-token attention against a cache prefix.

    q: (B, H, 1, D) float32; k/v: (B, H, T, D) float32 or bfloat16 caches;
    ``pos``: positions ``<= pos`` are attended (cache[pos] holds the current
    token's K/V, already written) — an int, one int32 on q's device, or a
    ``(B,)`` int32 vector on q's device with one position per batch entry
    (a position past the cache is read as its last one).
    Returns (B, H, 1, D) float32. ``block_k`` must divide T: the JAX
    kernel's contract, kept here; the CUDA kernel sizes its own shares. On
    the card q, k, v must be contiguous, k and v 16-byte aligned, and D in
    ``HEAD_DIMS``.
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
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention needs contiguous q, k and v")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention needs 16-byte aligned k and v")
    pos_t = _pos_tensor(pos, B, q.device)
    rows = B * H
    # row b*H + h reads pos_t[row // pos_stride]
    pos_stride = H if pos_t.numel() == B and B > 1 else rows
    n_split = decode_splits(rows, T, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part = torch.empty(rows * n_split * (D + 2), dtype=torch.float32,
                       device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _row_counters(q.device, stream, rows)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_t.data_ptr(),
                 out.data_ptr(), part.data_ptr(), counters.data_ptr(), rows,
                 T, pos_stride, D, n_split, int(k.dtype is torch.bfloat16),
                 1.0 / (D ** 0.5), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
