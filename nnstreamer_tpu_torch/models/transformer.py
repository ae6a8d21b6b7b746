"""Decoder-only transformer LM: config, parameters and the dense forward.

The port of nnstreamer_tpu's ``models/transformer.py`` for single-device
serving. Parameters are a plain dict in the JAX package's layout —
``embed`` (V, D), ``pos`` (max_seq, D), ``out_norm`` (D,), and per block
``ln1``, ``wqkv`` (D, 3D) used as ``h @ wqkv``, ``wo`` (D, D), ``ln2``,
``w1`` (D, F), ``w2`` (F, D) — with the un-embedding tied (``x @ embed.T``),
so weights converted from JAX need no transposes (``models/convert.py``).

Not in this package yet: MoE blocks, the mesh/context-parallel attention
modes and the training step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch

from ..utils.hw_accel import resolve_device

# decode_attn / prefill_attn values: "dense" (masked dense attention, the
# equivalence oracle) and "kernel" (the hand-written CUDA kernels,
# ops/decode_attention and ops/flash_attention); nnstreamer_tpu's names map
# onto them
_ATTN = {"dense": "dense", "kernel": "kernel",
         "xla": "dense", "pallas": "kernel"}


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    dim: int = 64
    heads: int = 4
    layers: int = 2
    mlp_mult: int = 4
    max_seq: int = 128
    # cached-decode and prompt-prefill attention: "dense" or "kernel"
    # ("xla" / "pallas", the JAX package's names, are accepted and
    # normalized)
    decode_attn: str = "dense"
    prefill_attn: str = "dense"

    def __post_init__(self):
        for name in ("decode_attn", "prefill_attn"):
            value = getattr(self, name)
            if value not in _ATTN:
                raise ValueError(
                    f"unknown {name} {value!r} (expected one of "
                    f"{sorted(_ATTN)})")
            object.__setattr__(self, name, _ATTN[value])
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} not divisible by heads {self.heads}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (default the card): weights normal × 0.02, norms at 1 — the
    JAX package's distribution, though not its numbers."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def ones():
        return torch.ones(cfg.dim, device=device)

    f = cfg.dim * cfg.mlp_mult
    params: Dict[str, Any] = {
        "embed": dense(cfg.vocab, cfg.dim),
        "pos": dense(cfg.max_seq, cfg.dim),
        "blocks": [],
        "out_norm": ones(),
    }
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": ones(),
            "wqkv": dense(cfg.dim, 3 * cfg.dim),
            "wo": dense(cfg.dim, cfg.dim),
            "ln2": ones(),
            "w1": dense(cfg.dim, f),
            "w2": dense(f, cfg.dim),
        })
    return params


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * g / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype: f32 activations against bf16 weights upcast
    the weight at use, as JAX promotes f32 @ bf16 to f32."""
    return x @ w.to(x.dtype)


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor
            ) -> torch.Tensor:
    """tokens (B, S) int → logits (B, S, V): the uncached full-sequence
    pass, the oracle that cached decoding is held against. Its attention
    is always dense, whatever ``prefill_attn`` says."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()] + params["pos"][:S][None, :, :]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    for blk in params["blocks"]:
        h = _rmsnorm(x, blk["ln1"])
        q, k, v = _mm(h, blk["wqkv"]).split(cfg.dim, dim=-1)

        def heads(t):
            return t.reshape(B, S, cfg.heads, cfg.head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(k), heads(v)                # (B,H,S,Dh)
        att = (q @ k.transpose(-1, -2)) / math.sqrt(cfg.head_dim)
        att = torch.softmax(att.masked_fill(~mask, -1e30), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, S, cfg.dim)
        x = x + _mm(o, blk["wo"])
        h = _rmsnorm(x, blk["ln2"])
        x = x + _mm(torch.relu(_mm(h, blk["w1"])), blk["w2"])
    x = _rmsnorm(x, params["out_norm"])
    return _mm(x, params["embed"].T)                          # tied un-embedding
