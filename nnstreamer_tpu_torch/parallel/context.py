"""Context (sequence) parallel attention: ring attention and Ulysses.

The port of nnstreamer_tpu's ``parallel/context.py``. There both run inside
``shard_map`` over a mesh axis; here every rank calls them on its local
blocks (one process per card, parallel/mesh.py), and the collectives are
parallel/collectives.py's, each with its backward:

* **Ring attention** (`ring_attention`): every rank holds a Q block and
  the K/V blocks rotate around the ring (rank j receives rank j+1's), with
  a numerically stable online softmax (running max and denominator) in
  the blocks' dtype. A causal block that lies wholly above the diagonal
  adds nothing but is computed all the same, as in the reference: every
  rank's backward must then run every inverse rotation, in one order.
* **Ulysses** (`ulysses_attention`): an all-to-all reshards from sequence
  to heads, exact local attention runs over the whole sequence for the
  rank's heads, and the inverse all-to-all reshards back. Needs
  ``heads % sp == 0`` (of the heads the rank holds).
* **Gathered** (`gathered_attention`, the ``gspmd`` form of
  ``attn_impl``): K and V all-gathered over the axis, the causal mask
  offset by the rank's block.
"""
from __future__ import annotations

from functools import partial

import torch

from . import collectives as C
from .mesh import axis_group, axis_index, axis_size


def _online_block(q, k, v, mask, m, l, o, scale):
    """One blockwise online-softmax accumulation step. q:(B,H,Sq,D)
    k,v:(B,H,Sk,D) mask:(Sq,Sk) bool (True = attend); m: running max,
    l: running denominator, o: running numerator."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.masked_fill(~mask, -1e30)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m_new) * mask
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l, o


def ring_attention(q, k, v, mesh, axis_name: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """Blockwise ring attention over ``axis_name`` of ``mesh``. q/k/v are
    this rank's sequence blocks (B, H, S_local, D); the global sequence is
    the blocks in axis order. Returns this rank's output block."""
    group = axis_group(mesh, axis_name)
    n, r = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    B, H, Sl, D = q.shape
    scale = 1.0 / (D ** 0.5)
    m = q.new_full((B, H, Sl, 1), -1e30)
    l = q.new_zeros((B, H, Sl, 1))
    o = q.new_zeros((B, H, Sl, D))
    rows = torch.arange(Sl, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        k_idx = (r + t) % n
        if causal:
            mask = (k_idx * Sl + rows)[None, :] <= (r * Sl + rows)[:, None]
        else:
            mask = torch.ones(Sl, Sl, dtype=torch.bool, device=q.device)
        m, l, o = _online_block(q, k_t, v_t, mask, m, l, o, scale)
        if t < n - 1:
            k_t = C.permute(k_t, group, 1)
            v_t = C.permute(v_t, group, 1)
    return o / torch.clamp(l, min=1e-30)


def _dense(q, k, v, causal: bool, row0: int = 0) -> torch.Tensor:
    S_q, S_k = q.shape[2], k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        rows = row0 + torch.arange(S_q, device=q.device)
        mask = torch.arange(S_k, device=q.device)[None, :] <= rows[:, None]
        scores = scores.masked_fill(~mask, -1e30)
    att = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    att = att / att.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True) -> torch.Tensor:
    """Ulysses (DeepSpeed-style) all-to-all attention over ``axis_name``:
    local blocks (B, H, S_local, D) with ``H % axis_size == 0``."""
    group = axis_group(mesh, axis_name)
    n = axis_size(mesh, axis_name)
    B, H, Sl, D = q.shape
    if H % n:
        raise ValueError(f"ulysses needs heads ({H}) divisible by sp ({n})")
    hn = H // n

    def to_heads(x):   # (B,H,Sl,D) -> (B,H/n,S,D)
        x = x.reshape(B, n, hn, Sl, D).transpose(0, 1)     # chunk j → rank j
        x = C.all_to_all(x, group)                         # chunk i ← rank i
        return x.permute(1, 2, 0, 3, 4).reshape(B, hn, n * Sl, D)

    def to_seq(x):     # (B,H/n,S,D) -> (B,H,Sl,D)
        x = x.reshape(B, hn, n, Sl, D).permute(2, 0, 1, 3, 4)
        x = C.all_to_all(x, group)
        return x.transpose(0, 1).reshape(B, H, Sl, D)

    return to_seq(_dense(to_heads(q), to_heads(k), to_heads(v), causal))


def gathered_attention(q, k, v, mesh, axis_name: str = "sp",
                       causal: bool = True) -> torch.Tensor:
    """Exact attention of this rank's query block against K and V
    all-gathered over ``axis_name``."""
    group = axis_group(mesh, axis_name)
    row0 = axis_index(mesh, axis_name) * q.shape[2]
    k = C.all_gather_sum(k, group, 2)
    v = C.all_gather_sum(v, group, 2)
    return _dense(q, k, v, causal, row0)


def make_context_attention(mesh, impl: str = "ring", causal: bool = True,
                           seq_axis: str = "sp"):
    """``attn(q, k, v)`` over this rank's blocks — its batch rows, its
    heads, the sequence block of its ``seq_axis`` index — returning its
    output block. ``impl``: "ring", "ulysses" or "gspmd" (gathered K/V)."""
    fns = {"ring": ring_attention, "ulysses": ulysses_attention,
           "gspmd": gathered_attention}
    if impl not in fns:
        raise ValueError(f"unknown context-attention impl '{impl}'")
    return partial(fns[impl], mesh=mesh, axis_name=seq_axis, causal=causal)
