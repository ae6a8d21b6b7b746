"""Autoregressive KV-cache decoding for the transformer LM.

The port of nnstreamer_tpu's ``models/decoding.py`` for single-device
serving: a prefill pass that fills a per-layer K/V cache, a single-token
decode step that attends against the cache, and a generation loop (a Python
loop where JAX has ``lax.scan``). The cache is allocated at ``max_seq`` (or
the serving ``cache_len``) and, unlike JAX's immutable arrays, written in
place — one position per layer per step, no second copy of the cache.

Types: activations are float32 throughout; parameters and the cache may be
bfloat16. ``k``/``v`` are cast to the cache's type before they are written;
``q`` stays float32.

With ``cfg.decode_attn == "kernel"`` the decode step's attention is the
hand-written CUDA kernel (``ops/decode_attention``), and with
``cfg.prefill_attn == "kernel"`` the prompt's causal self-attention is the
flash kernel (``ops/flash_attention``); on CPU tensors each takes its plain
version. ``"dense"`` is the masked dense path, the oracle. For dense
configs cached decoding picks the same greedy tokens as re-running the full
forward each step.

``prefill_continue`` ingests a chunk at a later position (multi-turn
serving) and stays dense: it attends a rectangular, offset window of the
cache, which the flash kernel does not compute.

Not in this package yet: the context-parallel cache and mesh sharding.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Optional, Tuple, Union

import torch

from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from .transformer import TransformerConfig, _mm, _rmsnorm

def init_cache(cfg: TransformerConfig, batch: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None) -> List[dict]:
    """Zeroed K/V cache: list of {"k","v"} (B, H, max_seq, head_dim)."""
    shape = (batch, cfg.heads, cfg.max_seq, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.layers)]


def _split_heads(cfg: TransformerConfig, t: torch.Tensor) -> torch.Tensor:
    B, S = t.shape[0], t.shape[1]
    return t.reshape(B, S, cfg.heads, cfg.head_dim).transpose(1, 2)


def _ffn(blk, h: torch.Tensor) -> torch.Tensor:
    return _mm(torch.relu(_mm(h, blk["w1"])), blk["w2"])


def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor,
            cache: List[dict]) -> Tuple[torch.Tensor, List[dict], int]:
    """Run the prompt (B, S) through the model, filling cache[:, :, :S].

    Returns (logits of the last position (B, V), cache, next position S).
    Attention inside the prompt is causal, the same math as ``forward``.
    """
    B, S = tokens.shape
    x = (params["embed"][tokens.long()]
         + params["pos"][:S][None, :, :]).float()
    kernel = cfg.prefill_attn == "kernel"
    if not kernel:
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    for li, blk in enumerate(params["blocks"]):
        h = _rmsnorm(x, blk["ln1"])
        q, k, v = (_split_heads(cfg, t)
                   for t in _mm(h, blk["wqkv"]).split(cfg.dim, dim=-1))
        cache[li]["k"][:, :, :S] = k
        cache[li]["v"][:, :, :S] = v
        if kernel:
            # one block of S satisfies the wrapper's contract for any S;
            # the kernel tiles (and masks a ragged S) on its own
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), True, S, S)
        else:
            att = (q @ k.transpose(-1, -2)) / math.sqrt(cfg.head_dim)
            att = torch.softmax(att.masked_fill(~mask, -1e30), dim=-1)
            o = att @ v
        o = o.transpose(1, 2).reshape(B, S, cfg.dim)
        x = x + _mm(o, blk["wo"])
        x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]))
    x = _rmsnorm(x[:, S - 1], params["out_norm"])
    return _mm(x, params["embed"].T), cache, S


def prefill_continue(cfg: TransformerConfig, params, tokens: torch.Tensor,
                     cache: List[dict], start: int
                     ) -> Tuple[torch.Tensor, List[dict], int]:
    """Chunked prefill: ingest ``tokens`` (B, P) at positions
    ``start..start+P-1``, attending causally over the cache prefix plus
    the chunk itself — the multi-turn ingestion primitive (one pass per
    conversation turn where a decode_step loop would take P). Writes the
    chunk's K/V into the cache in place. Returns (logits of the last
    position (B, V), cache, start + P).

    After this call the cache holds the states a from-scratch
    :func:`prefill` over history + chunk would produce."""
    B, P = tokens.shape
    T = cache[0]["k"].shape[2]
    if start < 0 or start + P > T:
        raise ValueError(
            f"chunk at {start}..{start + P - 1} does not fit the cache of "
            f"{T} positions")
    x = (params["embed"][tokens.long()]
         + params["pos"][start:start + P][None, :, :]).float()
    # only the prefix 0..start+P-1 is visible to the chunk
    end = start + P
    q_pos = start + torch.arange(P, device=x.device)
    visible = (torch.arange(end, device=x.device)[None, :]
               <= q_pos[:, None])                            # (P, end)
    for li, blk in enumerate(params["blocks"]):
        h = _rmsnorm(x, blk["ln1"])
        q, k, v = (_split_heads(cfg, t)
                   for t in _mm(h, blk["wqkv"]).split(cfg.dim, dim=-1))
        ck, cv = cache[li]["k"], cache[li]["v"]
        ck[:, :, start:end] = k
        cv[:, :, start:end] = v
        att = ((q @ ck[:, :, :end].float().transpose(-1, -2))
               / math.sqrt(cfg.head_dim))
        att = torch.softmax(att.masked_fill(~visible, -1e30), dim=-1)
        o = (att @ cv[:, :, :end].float()).transpose(1, 2).reshape(
            B, P, cfg.dim)
        x = x + _mm(o, blk["wo"])
        x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]))
    x = _rmsnorm(x[:, -1], params["out_norm"])
    return _mm(x, params["embed"].T), cache, end


def decode_step(cfg: TransformerConfig, params, token: torch.Tensor,
                pos: Union[int, torch.Tensor], cache: List[dict]
                ) -> Tuple[torch.Tensor, List[dict]]:
    """One token (B,) at position ``pos`` → (logits (B, V), cache).

    ``pos`` is an int (every row at one position) or a (B,) int32 tensor
    on the token's device, one position per row — the continuous engine
    steps its slots, each at its own position, in one call. Row b writes
    its K/V at cache[b, :, pos[b]] and attends against cache[b, :,
    :pos[b]+1]. A position past the cache is clamped to its last entry,
    as JAX clamps the start of ``dynamic_update_slice`` (the engines never
    step a live row there)."""
    B = token.shape[0]
    T = cache[0]["k"].shape[2]
    per_row = isinstance(pos, torch.Tensor)
    if per_row:
        if tuple(pos.shape) != (B,):
            raise ValueError(f"pos must be an int or ({B},), got "
                             f"{tuple(pos.shape)}")
        idx = pos.long().clamp(0, T - 1)                      # (B,)
        rows = torch.arange(B, device=token.device)
        pos_emb = params["pos"][idx]                          # (B, D)
    else:
        idx = min(max(int(pos), 0), T - 1)
        pos_emb = params["pos"][idx]
    x = (params["embed"][token.long()] + pos_emb).float()
    x = x[:, None, :]                                         # (B, 1, D)
    kernel = cfg.decode_attn == "kernel"
    if kernel:
        block_k = math.gcd(T, 128)
        if per_row:
            pos_t = pos.to(torch.int32)
        else:
            # one device-side position for every layer of this step
            pos_t = (torch.full((1,), int(pos), dtype=torch.int32,
                                device=x.device) if x.is_cuda else int(pos))
    else:
        t = torch.arange(T, device=x.device)
        visible = ((t[None, :] <= pos[:, None])[:, None, None, :] if per_row
                   else t <= pos)                             # (B,1,1,T)|(T,)
    for li, blk in enumerate(params["blocks"]):
        h = _rmsnorm(x, blk["ln1"])
        q, k, v = (_split_heads(cfg, t)
                   for t in _mm(h, blk["wqkv"]).split(cfg.dim, dim=-1))
        ck, cv = cache[li]["k"], cache[li]["v"]
        if per_row:
            ck[rows, :, idx] = k[:, :, 0].to(ck.dtype)
            cv[rows, :, idx] = v[:, :, 0].to(cv.dtype)
        else:
            ck[:, :, idx] = k[:, :, 0]
            cv[:, :, idx] = v[:, :, 0]
        if kernel:
            o = decode_attention(q.contiguous(), ck, cv, pos_t, block_k)
        else:
            att = (q @ ck.float().transpose(-1, -2)) / math.sqrt(cfg.head_dim)
            att = torch.softmax(att.masked_fill(~visible, -1e30), dim=-1)
            o = att @ cv.float()
        o = o.transpose(1, 2).reshape(B, 1, cfg.dim)
        x = x + _mm(o, blk["wo"])
        x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]))
    x = _rmsnorm(x[:, 0], params["out_norm"])
    return _mm(x, params["embed"].T), cache


def pick_token(logits: torch.Tensor, temperature: float,
               gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits → (B,) int32: temperature 0 = greedy (argmax, first
    maximum on ties); > 0 = a draw from softmax(logits / temperature) with
    the ``torch.Generator`` given."""
    if temperature > 0.0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].int()
    return torch.argmax(logits, dim=-1).int()


def make_generate(cfg: TransformerConfig, temperature: float = 0.0,
                  cache_len: int = 0):
    """Build ``generate(params, prompt (B, S), steps, generator=None) ->
    (B, S+steps) int32``: prefill picks the first token, then ``steps-1``
    decode steps follow. ``temperature`` 0 = greedy (argmax, first maximum
    on ties); > 0 = sampling from softmax(logits / temperature) with the
    ``torch.Generator`` given (default: seeded with 0 on the prompt's
    device).

    ``cache_len`` right-sizes the serving cache: every decode step reads
    the cache prefix, and a cache allocated at max_seq costs memory the
    request never uses. Pass the serving length (≤ cfg.max_seq); position
    embeddings still come from the full table. 0 = cfg.max_seq.

    The cache takes the parameters' dtype: bfloat16 parameters store a
    bfloat16 cache, halving the attention's reads.
    """
    if cache_len:
        if cache_len > cfg.max_seq:
            raise ValueError(
                f"cache_len {cache_len} exceeds the model's max_seq "
                f"{cfg.max_seq} (position table size)")
        cfg = replace(cfg, max_seq=cache_len)

    def generate(params, prompt: torch.Tensor, steps: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S = prompt.shape
        if steps < 1:
            raise ValueError(f"steps={steps} must be >= 1")
        if S + steps > cfg.max_seq:
            raise ValueError(
                f"prompt ({S}) + steps ({steps}) exceeds max_seq {cfg.max_seq}")
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=prompt.device).manual_seed(0)
        cache = init_cache(cfg, B, dtype=params["embed"].dtype,
                           device=prompt.device)
        logits, cache, pos = prefill(cfg, params, prompt, cache)
        token = pick_token(logits, temperature, generator)
        out = [token]
        for i in range(steps - 1):
            logits, cache = decode_step(cfg, params, token, pos + i, cache)
            token = pick_token(logits, temperature, generator)
            out.append(token)
        return torch.cat([prompt.int(), torch.stack(out, dim=1)], dim=1)

    return generate
