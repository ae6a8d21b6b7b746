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

An MoE model (``cfg.moe_experts``) routes each call's tokens through
parallel/moe.py: capacity and slots are those of the call's (B, S) or
(B, 1) tokens, as in the reference.

With a ``mesh`` (parallel/mesh.py; SPMD, one process per card) each rank
holds its block of the work, as models/transformer.py's meshed forward
does: the batch rows of its ``dp`` index (``tokens`` is that block), the
heads and FFN columns of its ``tp`` index (``params`` are its shards,
``transformer.shard_params``), and the cache block ``cache_pspecs`` names.
The output projection and the FFN's are summed over ``tp``
(``collectives.reduce_from``). Each rank's own attention is exactly the
kernels' function on its heads, so under a dp/tp mesh the decode step and
the prefill still launch both kernels — the reference keeps XLA's dense
path there, because a ``pallas_call`` does not partition. With
``context_parallel`` the cache's sequence axis is split over ``sp`` too:
the prompt goes through the ring (parallel/context.py) and each decode step
combines the ranks' partial softmax statistics
(:func:`make_sp_cache_attention`), both plain torch, as the reference's
are XLA.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import List, Optional, Tuple, Union

import torch

from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..parallel import collectives as C
from ..parallel.context import ring_attention
from ..parallel.mesh import axis_group, axis_index, axis_size
from ..parallel.moe import moe_ffn
from .transformer import TransformerConfig, _mm, _rmsnorm, _token_axes


def _cache_spec(context_parallel: bool) -> tuple:
    return ("dp", "tp", "sp" if context_parallel else None, None)


def cache_pspecs(cfg: TransformerConfig,
                 context_parallel: bool = False) -> List[dict]:
    """Per-layer cache specs, one entry per dim naming the mesh axis that
    dim is split over (``param_pspecs``' form): batch over ``dp``, heads
    over ``tp`` and, with ``context_parallel``, the sequence over ``sp``
    (each rank then holds max_seq/sp positions)."""
    spec = _cache_spec(context_parallel)
    return [{"k": spec, "v": spec} for _ in range(cfg.layers)]


def init_cache(cfg: TransformerConfig, batch: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[torch.device] = None, mesh=None,
               context_parallel: bool = False) -> List[dict]:
    """Zeroed K/V cache: list of {"k","v"} (B, H, max_seq, head_dim) for
    the global ``batch`` B; with a ``mesh``, this rank's block of it per
    :func:`cache_pspecs` — (B/dp, H/tp, max_seq[/sp], head_dim)."""
    shape = [batch, cfg.heads, cfg.max_seq, cfg.head_dim]
    for dim, axis in enumerate(_cache_spec(context_parallel)):
        n = axis_size(mesh, axis) if axis else 1
        if shape[dim] % n:
            raise ValueError(f"cache dim {dim} ({shape[dim]}) not divisible "
                             f"by {axis}={n}")
        shape[dim] //= n
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.layers)]


def _split_heads(cfg: TransformerConfig, t: torch.Tensor,
                 heads: int) -> torch.Tensor:
    B, S = t.shape[0], t.shape[1]
    return t.reshape(B, S, heads, cfg.head_dim).transpose(1, 2)


def _qkv(cfg: TransformerConfig, blk, h: torch.Tensor, heads: int, mesh):
    """q, k, v (B, heads, S, Dh) of this rank's heads."""
    h = C.copy_to(h, axis_group(mesh, "tp"))
    return (_split_heads(cfg, t, heads) for t in
            _mm(h, blk["wqkv"]).split(heads * cfg.head_dim, dim=-1))


def _out(blk, o: torch.Tensor, mesh) -> torch.Tensor:
    """The attention output (B, heads, S, Dh) through ``wo``, summed over
    the tp ranks' heads."""
    B, H, S, D = o.shape
    o = o.transpose(1, 2).reshape(B, S, H * D)
    return C.reduce_from(_mm(o, blk["wo"]), axis_group(mesh, "tp"))


def _ffn(blk, h: torch.Tensor, cfg: TransformerConfig, mesh=None,
         token_axes=None) -> torch.Tensor:
    """The block's FFN: dense (its tp columns, summed over tp), or the
    switch MoE (parallel/moe.py, experts over tp) over the call's tokens —
    all of a prompt's at prefill, one a row at decode, as the reference
    routes them; with a mesh, routing counts the tokens of every rank
    that ``token_axes`` (default dp) splits them over."""
    if "moe" in blk:
        return moe_ffn(blk["moe"], h, mesh, ep_axis="tp",
                       capacity_factor=cfg.moe_capacity_factor,
                       token_axes=token_axes)
    group = axis_group(mesh, "tp")
    h = C.copy_to(h, group)
    return C.reduce_from(_mm(torch.relu(_mm(h, blk["w1"])), blk["w2"]),
                         group)


def make_sp_cache_attention(cfg: TransformerConfig, mesh):
    """Context-parallel cached attention: the cache's sequence axis is
    split over ``sp``; each rank scores its slice and the partial softmax
    statistics combine over ``sp`` — a MAX of the local maxima, then SUMs
    of the denominators and the numerators (the reference's
    ``pmax``/``psum``, plain torch collectives here). The decode-side
    counterpart of ring attention (parallel/context.py): a rank holds
    max_seq/sp positions of the cache.

    Returns ``attn(q, k_new, v_new, ck, cv, pos) -> o``: q/k_new/v_new
    (B, H, 1, Dh) of this rank's rows and heads, ck/cv its (B, H,
    max_seq/sp, Dh) slices, ``pos`` an int. The rank whose slice holds
    ``pos`` writes k_new/v_new there, in place."""
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    if "sp" not in names:
        raise ValueError(
            "context-parallel decoding needs an 'sp' axis in the mesh "
            f"(got axes {list(names)})")
    sp = axis_size(mesh, "sp")
    if cfg.max_seq % sp:
        raise ValueError(
            f"max_seq {cfg.max_seq} must divide by the sp axis size {sp}")
    local = cfg.max_seq // sp
    start = axis_index(mesh, "sp") * local
    group = axis_group(mesh, "sp")
    scale = math.sqrt(cfg.head_dim)

    def attn(q, k_new, v_new, ck, cv, pos) -> torch.Tensor:
        if isinstance(pos, torch.Tensor):
            raise TypeError("context-parallel decoding takes one int "
                            "position for every row")
        lp = pos - start
        if 0 <= lp < local:
            ck[:, :, lp] = k_new[:, :, 0]
            cv[:, :, lp] = v_new[:, :, 0]
        scores = (q @ ck.float().transpose(-1, -2)) / scale   # (B,H,1,local)
        visible = start + torch.arange(local, device=q.device) <= pos
        scores = scores.masked_fill(~visible, float("-inf"))
        # a slice wholly past pos has a local max of -inf: exp(-inf - gm)
        # is 0, so it adds nothing
        gm = C.all_reduce_plain(scores.amax(dim=-1), group,
                                op=torch.distributed.ReduceOp.MAX)
        p = torch.exp(scores - gm[..., None]).masked_fill(~visible, 0.0)
        denom = C.all_reduce_plain(p.sum(dim=-1), group)       # (B,H,1)
        num = C.all_reduce_plain(p @ cv.float(), group)         # (B,H,1,Dh)
        return num / denom[..., None]

    return attn


def prefill(cfg: TransformerConfig, params, tokens: torch.Tensor,
            cache: List[dict], mesh=None, context_parallel: bool = False
            ) -> Tuple[torch.Tensor, List[dict], int]:
    """Run the prompt (B, S) through the model, filling cache[:, :, :S].

    Returns (logits of the last position (B, V), cache, next position S).
    Attention inside the prompt is causal, the same math as ``forward``.

    With a ``mesh``, ``tokens`` is this rank's dp block and ``cache`` its
    block (:func:`init_cache`). With ``context_parallel`` the prompt is
    padded to a multiple of sp and each rank runs its sequence block
    through the ring; every rank's K/V blocks are all-gathered over sp and
    each keeps its cache slice's positions. Padding sits at positions past
    the prompt, which causal masking hides and the decode steps overwrite
    before they become visible. The last real position's hidden state is
    summed over sp from the rank that holds it, so every rank gets the
    logits.
    """
    B, S = tokens.shape
    S_real = S
    H = cache[0]["k"].shape[1]
    sp_group, s0, token_axes = None, 0, None
    if context_parallel:
        if mesh is None:
            raise ValueError("context_parallel prefill needs a mesh")
        sp = axis_size(mesh, "sp")
        local = cache[0]["k"].shape[2]
        pad = (-S) % sp
        if S + pad > local * sp:
            raise ValueError(
                f"prompt ({S}) padded to the sp multiple ({S + pad}) "
                f"exceeds max_seq {local * sp}")
        if pad:
            tokens = torch.nn.functional.pad(tokens, (0, pad))
            S += pad
        sp_group = axis_group(mesh, "sp")
        S_l = S // sp
        s0 = axis_index(mesh, "sp") * S_l
        c0 = axis_index(mesh, "sp") * local
        tokens = tokens[:, s0:s0 + S_l]
        token_axes = _token_axes(mesh)
    else:
        S_l = S
    x = (params["embed"][tokens.long()]
         + params["pos"][s0:s0 + S_l][None, :, :]).float()
    kernel = cfg.prefill_attn == "kernel" and not context_parallel
    if not kernel and not context_parallel:
        mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(cfg, blk, _rmsnorm(x, blk["ln1"]), H, mesh)
        if context_parallel:
            o = ring_attention(q, k, v, mesh)
            # every rank gathers (a collective), the ranks whose slice
            # holds prompt positions keep them
            n = min(S, c0 + local) - c0
            for name, t in (("k", k), ("v", v)):
                full = C.all_gather_plain(t, sp_group, 2)
                if n > 0:
                    cache[li][name][:, :, :n] = full[:, :, c0:c0 + n]
        else:
            cache[li]["k"][:, :, :S] = k
            cache[li]["v"][:, :, :S] = v
            if kernel:
                # one block of S satisfies the wrapper's contract for any
                # S; the kernel tiles (and masks a ragged S) on its own
                o = flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), True, S, S)
            else:
                att = (q @ k.transpose(-1, -2)) / math.sqrt(cfg.head_dim)
                att = torch.softmax(att.masked_fill(~mask, -1e30), dim=-1)
                o = att @ v
        x = x + _out(blk, o, mesh)
        x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]), cfg, mesh, token_axes)
    last = S_real - 1 - s0
    if context_parallel:
        xl = (x[:, last].clone() if 0 <= last < S_l
              else x.new_zeros(B, x.shape[-1]))
        x = C.all_reduce_plain(xl, sp_group)
    else:
        x = x[:, last]
    x = _rmsnorm(x, params["out_norm"])
    return _mm(x, params["embed"].T), cache, S_real


def prefill_continue(cfg: TransformerConfig, params, tokens: torch.Tensor,
                     cache: List[dict], start: int, mesh=None
                     ) -> Tuple[torch.Tensor, List[dict], int]:
    """Chunked prefill: ingest ``tokens`` (B, P) at positions
    ``start..start+P-1``, attending causally over the cache prefix plus
    the chunk itself — the multi-turn ingestion primitive (one pass per
    conversation turn where a decode_step loop would take P). Writes the
    chunk's K/V into the cache in place. Returns (logits of the last
    position (B, V), cache, start + P).

    After this call the cache holds the states a from-scratch
    :func:`prefill` over history + chunk would produce. With a ``mesh``
    (dp/tp; not context-parallel) as :func:`prefill`."""
    B, P = tokens.shape
    H = cache[0]["k"].shape[1]
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
        q, k, v = _qkv(cfg, blk, _rmsnorm(x, blk["ln1"]), H, mesh)
        ck, cv = cache[li]["k"], cache[li]["v"]
        ck[:, :, start:end] = k
        cv[:, :, start:end] = v
        att = ((q @ ck[:, :, :end].float().transpose(-1, -2))
               / math.sqrt(cfg.head_dim))
        att = torch.softmax(att.masked_fill(~visible, -1e30), dim=-1)
        x = x + _out(blk, att @ cv[:, :, :end].float(), mesh)
        x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]), cfg, mesh)
    x = _rmsnorm(x[:, -1], params["out_norm"])
    return _mm(x, params["embed"].T), cache, end


def decode_step(cfg: TransformerConfig, params, token: torch.Tensor,
                pos: Union[int, torch.Tensor], cache: List[dict],
                mesh=None, sp_attn=None) -> Tuple[torch.Tensor, List[dict]]:
    """One token (B,) at position ``pos`` → (logits (B, V), cache).

    ``pos`` is an int (every row at one position) or a (B,) int32 tensor
    on the token's device, one position per row — the continuous engine
    steps its slots, each at its own position, in one call. Row b writes
    its K/V at cache[b, :, pos[b]] and attends against cache[b, :,
    :pos[b]+1]. A position past the cache is clamped to its last entry,
    as JAX clamps the start of ``dynamic_update_slice`` (the engines never
    step a live row there).

    With a ``mesh`` (dp/tp) ``token`` holds this rank's rows and each
    rank attends its heads through the kernel; with ``sp_attn`` (from
    :func:`make_sp_cache_attention`) the cache stays split over sp and
    attention combines the ranks' partials."""
    B = token.shape[0]
    H = cache[0]["k"].shape[1]
    T = cache[0]["k"].shape[2] * (axis_size(mesh, "sp") if sp_attn else 1)
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
    kernel = cfg.decode_attn == "kernel" and sp_attn is None
    if kernel:
        block_k = math.gcd(T, 128)
        if per_row:
            pos_t = pos.to(torch.int32)
        else:
            # one device-side position for every layer of this step
            pos_t = (torch.full((1,), int(pos), dtype=torch.int32,
                                device=x.device) if x.is_cuda else int(pos))
    elif sp_attn is None:
        t = torch.arange(T, device=x.device)
        visible = ((t[None, :] <= pos[:, None])[:, None, None, :] if per_row
                   else t <= pos)                             # (B,1,1,T)|(T,)
    for li, blk in enumerate(params["blocks"]):
        q, k, v = _qkv(cfg, blk, _rmsnorm(x, blk["ln1"]), H, mesh)
        ck, cv = cache[li]["k"], cache[li]["v"]
        if sp_attn is not None:
            o = sp_attn(q, k, v, ck, cv, pos)
        else:
            if per_row:
                ck[rows, :, idx] = k[:, :, 0].to(ck.dtype)
                cv[rows, :, idx] = v[:, :, 0].to(cv.dtype)
            else:
                ck[:, :, idx] = k[:, :, 0]
                cv[:, :, idx] = v[:, :, 0]
            if kernel:
                o = decode_attention(q.contiguous(), ck, cv, pos_t, block_k)
            else:
                att = ((q @ ck.float().transpose(-1, -2))
                       / math.sqrt(cfg.head_dim))
                att = torch.softmax(att.masked_fill(~visible, -1e30), dim=-1)
                o = att @ cv.float()
        x = x + _out(blk, o, mesh)
        x = x + _ffn(blk, _rmsnorm(x, blk["ln2"]), cfg, mesh)
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
                  cache_len: int = 0, *, mesh=None,
                  context_parallel: bool = False):
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

    With ``mesh`` (SPMD, every rank calls ``generate`` together) ``params``
    are this rank's shards, ``prompt`` its dp block and the result its
    rows; the cache is split per :func:`cache_pspecs`. With
    ``context_parallel`` its sequence axis is split over ``sp`` as well
    and attention runs through the ring and :func:`make_sp_cache_attention`.
    """
    if cache_len:
        if cache_len > cfg.max_seq:
            raise ValueError(
                f"cache_len {cache_len} exceeds the model's max_seq "
                f"{cfg.max_seq} (position table size)")
        cfg = replace(cfg, max_seq=cache_len)
    sp_attn = None
    if context_parallel:
        if mesh is None:
            raise ValueError("context_parallel decoding needs a mesh")
        sp_attn = make_sp_cache_attention(cfg, mesh)

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
        cache = init_cache(cfg, B * axis_size(mesh, "dp"),
                           dtype=params["embed"].dtype,
                           device=prompt.device, mesh=mesh,
                           context_parallel=context_parallel)
        logits, cache, pos = prefill(cfg, params, prompt, cache, mesh,
                                     context_parallel)
        token = pick_token(logits, temperature, generator)
        out = [token]
        for i in range(steps - 1):
            logits, cache = decode_step(cfg, params, token, pos + i, cache,
                                        mesh, sp_attn)
            token = pick_token(logits, temperature, generator)
            out.append(token)
        return torch.cat([prompt.int(), torch.stack(out, dim=1)], dim=1)

    return generate
