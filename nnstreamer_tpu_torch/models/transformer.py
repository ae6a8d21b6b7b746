"""Decoder-only transformer LM: config, parameters, the forward, the loss
and the train step, meshless or over a dp/tp/sp mesh.

The port of nnstreamer_tpu's ``models/transformer.py``. Parameters are a
plain dict in the JAX package's layout — ``embed`` (V, D), ``pos``
(max_seq, D), ``out_norm`` (D,), and per block ``ln1``, ``wqkv`` (D, 3D)
used as ``h @ wqkv``, ``wo`` (D, D), ``ln2``, and either ``w1`` (D, F),
``w2`` (F, D) or an MoE ``moe`` {wr, w1, w2} (parallel/moe.py) — with the
un-embedding tied (``x @ embed.T``), so weights converted from JAX need no
transposes (``models/convert.py``).

With a ``mesh`` (parallel/mesh.py) the program is SPMD, one process per
card: each rank holds the batch rows of its ``dp`` index, the sequence
block of its ``sp`` index and the heads, MLP columns and experts of its
``tp`` index (Megatron's split: ``wqkv`` by whole heads within each of q, k
and v, ``wo`` and ``w2`` by rows, ``w1`` by columns; ``shard_params`` cuts
them). Attention over ``sp`` follows ``cfg.attn_impl``: ``gspmd``
all-gathers K and V with the causal mask offset by the rank's block,
``ring`` and ``ulysses`` are parallel/context.py's. The loss of a rank is
its share (the shares over dp × sp sum to the loss), and the train step
all-reduces the gradients over dp and sp.

The training forward's attention is dense PyTorch (as the reference's is
XLA): the CUDA kernels have no backward. Serving goes through
models/decoding.py, which uses them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..parallel import collectives as C
from ..parallel.mesh import axis_group, axis_index, axis_size, mesh_device
from ..utils.hw_accel import resolve_device
from ..utils.tree import tree_leaves, tree_map  # noqa: F401 (re-exported)

# decode_attn / prefill_attn values: "dense" (masked dense attention, the
# equivalence oracle) and "kernel" (the hand-written CUDA kernels,
# ops/decode_attention and ops/flash_attention); nnstreamer_tpu's names map
# onto them
_ATTN = {"dense": "dense", "kernel": "kernel",
         "xla": "dense", "pallas": "kernel"}
ATTN_IMPLS = ("gspmd", "ring", "ulysses")


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    dim: int = 64
    heads: int = 4
    layers: int = 2
    mlp_mult: int = 4
    max_seq: int = 128
    # attention over the sp axis of a mesh: "gspmd" (K/V all-gathered),
    # "ring" (K/V rotated with an online softmax) or "ulysses" (all-to-all
    # from sequence to heads and back) — parallel/context.py
    attn_impl: str = "gspmd"
    # cached-decode and prompt-prefill attention: "dense" or "kernel"
    # ("xla" / "pallas", the JAX package's names, are accepted and
    # normalized)
    decode_attn: str = "dense"
    prefill_attn: str = "dense"
    # >0 replaces the dense FFN with a switch-routed MoE of this many
    # experts, split over the tp axis (parallel/moe.py)
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01  # switch-transformer load-balance coeff

    def __post_init__(self):
        for name in ("decode_attn", "prefill_attn"):
            value = getattr(self, name)
            if value not in _ATTN:
                raise ValueError(
                    f"unknown {name} {value!r} (expected one of "
                    f"{sorted(_ATTN)})")
            object.__setattr__(self, name, _ATTN[value])
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r} "
                             f"(expected one of {ATTN_IMPLS})")
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
    from ..parallel.moe import init_moe_params

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
        block = {"ln1": ones(),
                 "wqkv": dense(cfg.dim, 3 * cfg.dim),
                 "wo": dense(cfg.dim, cfg.dim),
                 "ln2": ones()}
        if cfg.moe_experts > 0:
            block["moe"] = init_moe_params(gen, cfg.dim, f, cfg.moe_experts,
                                           device=device)
        else:
            block["w1"] = dense(cfg.dim, f)
            block["w2"] = dense(f, cfg.dim)
        params["blocks"].append(block)
    return params


def param_pspecs(cfg: TransformerConfig) -> Dict[str, Any]:
    """Per-leaf specs, one entry per dim naming the mesh axis that dim is
    split over (None = replicated): tensor parallel over "tp", Megatron
    style (column-parallel in, row-parallel out). ``wqkv``'s "tp" splits
    whole heads within each of q, k and v; experts ride "tp" too."""
    from ..parallel.moe import moe_pspecs

    block: Dict[str, Any] = {"ln1": (None,), "wqkv": (None, "tp"),
                             "wo": ("tp", None), "ln2": (None,)}
    if cfg.moe_experts > 0:
        block["moe"] = moe_pspecs(ep_axis="tp")
    else:
        block["w1"] = (None, "tp")
        block["w2"] = ("tp", None)
    return {"embed": (None, None), "pos": (None, None),
            "blocks": [dict(block) for _ in range(cfg.layers)],
            "out_norm": (None,)}


def _qkv_cols(cfg: TransformerConfig, t: int, tp: int) -> torch.Tensor:
    """Columns of ``wqkv`` held by tp rank ``t``: its heads' columns of q,
    then of k, then of v."""
    w = cfg.dim // tp
    return torch.cat([torch.arange(p * cfg.dim + t * w, p * cfg.dim + (t + 1) * w)
                      for p in range(3)])


def _shard_leaf(cfg: TransformerConfig, name: str, leaf: torch.Tensor,
                spec, mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        if name == "wqkv":
            leaf = leaf[:, _qkv_cols(cfg, i, n).to(leaf.device)]
        else:
            leaf = leaf.chunk(n, dim=dim)[i]
    return leaf.contiguous()


def _named_map(fn, params, specs, name=None):
    if isinstance(params, dict):
        return {k: _named_map(fn, v, specs[k], k) for k, v in params.items()}
    if isinstance(params, list):
        return [_named_map(fn, v, s, name) for v, s in zip(params, specs)]
    return fn(name, params, specs)


def shard_params(cfg: TransformerConfig, mesh, params) -> Dict[str, Any]:
    """The full parameters (the same on every rank) → this rank's shards."""
    if mesh is None:
        return params
    if cfg.dim % axis_size(mesh, "tp") or cfg.heads % axis_size(mesh, "tp"):
        raise ValueError(f"heads {cfg.heads} / dim {cfg.dim} not divisible "
                         f"by tp={axis_size(mesh, 'tp')}")
    return _named_map(lambda n, p, s: _shard_leaf(cfg, n, p, s, mesh),
                      params, param_pspecs(cfg))


def gather_params(cfg: TransformerConfig, mesh, params) -> Dict[str, Any]:
    """This rank's shards → the full parameters (every rank calls it)."""
    if mesh is None:
        return params

    def gather(name, leaf, spec):
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = axis_size(mesh, axis)
            full = C.all_gather_plain(leaf, axis_group(mesh, axis), dim)
            if name == "wqkv":
                cols = torch.cat([_qkv_cols(cfg, i, n) for i in range(n)])
                out = torch.empty_like(full)
                out[:, cols.to(full.device)] = full
                full = out
            leaf = full
        return leaf

    return _named_map(gather, params, param_pspecs(cfg))


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x * g / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype: f32 activations against bf16 weights upcast
    the weight at use, as JAX promotes f32 @ bf16 to f32."""
    return x @ w.to(x.dtype)


def _token_axes(mesh) -> Tuple[Tuple[str, int], ...]:
    """The axes that split an activation's tokens: dp over the batch, sp
    over the sequence."""
    if mesh is None:
        return ()
    return tuple((a, d) for a, d in (("dp", 0), ("sp", 1))
                 if a in mesh.mesh_dim_names)


def _attention(cfg: TransformerConfig, q, k, v, mesh) -> torch.Tensor:
    """Causal attention of the (B, H_local, S_local, Dh) blocks: over the
    mesh's sp axis by ``cfg.attn_impl``, else dense."""
    if mesh is not None and "sp" in mesh.mesh_dim_names:
        from ..parallel.context import make_context_attention

        return make_context_attention(mesh, impl=cfg.attn_impl)(q, k, v)
    S = q.shape[2]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    att = (q @ k.transpose(-1, -2)) / math.sqrt(cfg.head_dim)
    att = torch.softmax(att.masked_fill(~mask, -1e30), dim=-1)
    return att @ v


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, mesh=None,
            return_aux: bool = False):
    """tokens (B, S) int → logits (B, S, V), or (logits, aux_loss) with
    ``return_aux`` (the MoE load-balance term summed over the layers, 0
    for dense). The uncached full-sequence pass, the oracle that cached
    decoding is held against; its attention is always dense PyTorch.

    With ``mesh``: ``tokens`` is this rank's dp block of the batch with
    the whole sequence, ``params`` this rank's shards, and the logits are
    those of its sp block of the sequence."""
    from ..parallel.moe import moe_ffn

    sp = axis_size(mesh, "sp")
    B, S = tokens.shape
    if S % sp:
        raise ValueError(f"sequence {S} not divisible by sp={sp}")
    S_l = S // sp
    s0 = axis_index(mesh, "sp") * S_l
    tokens = tokens[:, s0:s0 + S_l]
    tp_group = axis_group(mesh, "tp")
    H_l = cfg.heads // axis_size(mesh, "tp")
    x = params["embed"][tokens.long()] + params["pos"][s0:s0 + S_l][None]
    aux_total = x.new_zeros((), dtype=torch.float32)
    for blk in params["blocks"]:
        h = C.copy_to(_rmsnorm(x, blk["ln1"]), tp_group)
        q, k, v = _mm(h, blk["wqkv"]).split(H_l * cfg.head_dim, dim=-1)

        def heads(t):
            return t.reshape(B, S_l, H_l, cfg.head_dim).transpose(1, 2)

        o = _attention(cfg, heads(q), heads(k), heads(v), mesh)
        o = o.transpose(1, 2).reshape(B, S_l, H_l * cfg.head_dim)
        x = x + C.reduce_from(_mm(o, blk["wo"]), tp_group)
        h = _rmsnorm(x, blk["ln2"])
        if "moe" in blk:
            y, aux = moe_ffn(blk["moe"], h, mesh, ep_axis="tp",
                             capacity_factor=cfg.moe_capacity_factor,
                             return_aux=True, token_axes=_token_axes(mesh))
            x = x + y
            aux_total = aux_total + aux
        else:
            h = C.copy_to(h, tp_group)
            x = x + C.reduce_from(
                _mm(torch.relu(_mm(h, blk["w1"])), blk["w2"]), tp_group)
    x = _rmsnorm(x, params["out_norm"])
    logits = _mm(x, params["embed"].T)                       # tied un-embedding
    if return_aux:
        return logits, aux_total
    return logits


def _log_likelihood(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """log softmax(logits) at each int64 target."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, targets[..., None])[..., 0]


def lm_loss(cfg: TransformerConfig, logits: torch.Tensor,
            targets: torch.Tensor, aux) -> torch.Tensor:
    """The training objective: the mean cross entropy of ``logits`` at
    the int64 ``targets`` plus the MoE load-balance term ``aux`` × its
    weight (``loss_fn`` without a mesh; models/lm_train.py's loss)."""
    return -_log_likelihood(logits, targets).mean() \
        + cfg.moe_aux_weight * aux


def loss_fn(cfg: TransformerConfig, params, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy + the MoE load-balance term × its weight.

    With ``mesh``: ``tokens`` (B/dp, S+1) is this rank's dp block and the
    result is this rank's share — its tokens' summed loss over the global
    token count, plus the aux term over the dp × sp ranks — so the shares
    of the dp × sp ranks sum to the loss (the tp ranks hold equal ones)."""
    logits, aux = forward(cfg, params, tokens[:, :-1], mesh, return_aux=True)
    sp = axis_size(mesh, "sp")
    S_l = (tokens.shape[1] - 1) // sp
    s0 = axis_index(mesh, "sp") * S_l
    targets = tokens[:, 1:][:, s0:s0 + S_l].long()
    if mesh is None:
        return lm_loss(cfg, logits, targets, aux)
    ll = _log_likelihood(logits, targets)
    ranks = axis_size(mesh, "dp") * sp
    n = ll.numel() * ranks
    return -ll.sum() / n + cfg.moe_aux_weight * aux / ranks


def loss_and_grads(cfg: TransformerConfig, params, tokens: torch.Tensor,
                   mesh=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, grads): the loss (summed over the dp × sp shares with a
    mesh) and the gradient of each of this rank's leaves, all-reduced over
    dp and sp."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = tree_leaves(leaves)
    loss = loss_fn(cfg, leaves, tokens, mesh)
    grads = torch.autograd.grad(loss, flat)
    loss = loss.detach()
    for axis in ("sp", "dp"):
        group = axis_group(mesh, axis)
        if group is not None:
            for g in grads:
                C.all_reduce_plain(g, group)
            C.all_reduce_plain(loss, group)
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


def make_train_step(cfg: TransformerConfig, mesh=None, lr: float = 1e-2):
    """Build ``(step, shard_params, data_sharding)``: ``step(params,
    tokens) -> (params, loss)`` is one SGD step ``p - lr·g`` of this
    rank's shards on its dp block of tokens, ``loss`` the global loss (the
    same on every rank); ``shard_params(full)`` cuts the full parameters
    into this rank's shards; ``data_sharding(tokens)`` takes this rank's
    dp block of a global batch. Without a mesh the step is the plain one
    and the other two are identities."""
    if cfg.moe_experts > 0:
        tp = axis_size(mesh, "tp")
        if cfg.moe_experts % tp:
            raise ValueError(
                f"moe_experts={cfg.moe_experts} must be divisible by the "
                f"tp axis size {tp} (experts are sharded over tp)")

    def step(params, tokens):
        loss, grads = loss_and_grads(cfg, params, tokens, mesh)
        with torch.no_grad():
            params = tree_map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    def shard(params):
        return shard_params(cfg, mesh, params)

    def data_sharding(tokens) -> torch.Tensor:
        """The global (B, S+1) batch (numpy or a tensor, the same on every
        rank) → this rank's dp block on its device: the reference's
        ``P("dp", None)``."""
        t = torch.as_tensor(tokens)
        if mesh is None:
            return t
        dp = axis_size(mesh, "dp")
        if t.shape[0] % dp:
            raise ValueError(f"batch {t.shape[0]} not divisible by dp={dp}")
        t = t.chunk(dp, dim=0)[axis_index(mesh, "dp")]
        return t.contiguous().to(mesh_device(mesh))

    return step, shard, data_sharding
