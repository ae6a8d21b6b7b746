"""Expert parallelism: a switch-routed (top-1) mixture-of-experts FFN with
the experts split over a mesh axis.

The port of nnstreamer_tpu's ``parallel/moe.py``. Two dispatch forms with
the same token → slot assignment:

* ``dispatch="scatter"`` (default): tokens are added into a flat
  (E·C + 1, D) slot buffer by ``index_add`` (overflow tokens land in the
  last row, which is dropped, as the reference's out-of-range
  ``mode="drop"`` scatter drops them) and gathered back after the expert
  compute. O(T·D) dispatch work.
* ``dispatch="dense"``: one-hot (T, E, C) dispatch/combine einsums, the
  equivalence oracle.

Capacity: each expert takes at most ``ceil(tokens / experts ×
capacity_factor)`` tokens; a token's slot is its rank among its expert's
tokens in token order, so the first come are kept and the rest fall through
the residual (zero from the MoE branch). Routing stays float32 whatever the
activations' type (bfloat16 counters round above 256). ``gate`` is
``amax``, whose gradient is split evenly over tied maxima as JAX's ``max``
is (``torch.max(dim)`` would send it to one index).

With a ``mesh``: ``x`` is this rank's block of the tokens, split over the
mesh axes named in ``token_axes`` (``(axis, dim)`` pairs; the
transformer's are dp over the batch and sp over the sequence) and the same
on every rank of ``ep_axis``. Capacity and slots are those of the global
token order: each rank gathers the others' expert choices (int64s, no
gradient), counts, and adds its tokens into the global slot buffer, which
is summed over the token axes. Each rank of ``ep_axis`` computes its
E / ep experts and the outputs are gathered over ``ep_axis``
(parallel/collectives.py gives each step its backward).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import collectives as C
from .mesh import axis_group, axis_index, axis_size


def init_moe_params(generator: torch.Generator, dim: int, hidden: int,
                    num_experts: int, scale: float = 0.02,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
    """Router + per-expert FFN weights: wr (D,E), w1 (E,D,F), w2 (E,F,D),
    normal × ``scale`` from ``generator`` (the JAX package's distribution,
    not its numbers)."""
    device = device if device is not None else generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device) * scale

    return {"wr": normal(dim, num_experts),
            "w1": normal(num_experts, dim, hidden),
            "w2": normal(num_experts, hidden, dim)}


def moe_pspecs(ep_axis: str = "ep") -> Dict[str, Tuple]:
    """Per-leaf specs, one entry per dim (the mesh axis that dim is split
    over, or None): the router is replicated, the experts split over
    ``ep_axis``."""
    return {"wr": (None, None),
            "w1": (ep_axis, None, None),
            "w2": (ep_axis, None, None)}


def _token_order(t: torch.Tensor, mesh, token_axes, gather: bool
                 ) -> torch.Tensor:
    """``gather``: this rank's block of a per-token tensor → the global
    one; else the global → this rank's block."""
    for axis, dim in token_axes:
        if gather:
            t = C.all_gather_plain(t, axis_group(mesh, axis), dim)
        else:
            t = t.chunk(axis_size(mesh, axis), dim=dim)[
                axis_index(mesh, axis)]
    return t


def _route(params, xt: torch.Tensor, C_: int, lead_shape, mesh=None,
           token_axes: Sequence = ()):
    """Switch routing: logits, gate, expert, one-hot, slot position and
    keep mask of each local token (in global token order)."""
    E = params["wr"].shape[1]
    logits = xt.float() @ params["wr"].float()
    probs = torch.softmax(logits, dim=-1)
    gate = probs.amax(dim=-1)                                  # (T,)
    expert = probs.argmax(dim=-1)                              # (T,)
    onehot = F.one_hot(expert, E).float()                      # (T, E)
    if mesh is None or not token_axes:
        pos_e = (torch.cumsum(onehot, dim=0) - onehot) * onehot
    else:
        glob = _token_order(expert.reshape(lead_shape), mesh, token_axes,
                            gather=True)
        g1 = F.one_hot(glob.reshape(-1), E).float()
        g_pos = ((torch.cumsum(g1, dim=0) - g1) * g1).reshape(
            tuple(glob.shape) + (E,))
        pos_e = _token_order(g_pos, mesh, token_axes,
                             gather=False).reshape(-1, E)
    pos = pos_e.sum(-1).to(torch.int64)                        # (T,)
    keep = pos < C_
    return logits, gate, expert, onehot, pos, keep


def _expert_compute(params, expert_in: torch.Tensor, mesh, ep_axis: str
                    ) -> torch.Tensor:
    """Batched per-expert FFN over (E, C, D); each rank of ``ep_axis``
    runs its E / ep experts (the leaves it holds) and the outputs are
    gathered back to (E, C, D)."""
    group = axis_group(mesh, ep_axis)
    n_local = params["w1"].shape[0]
    if group is not None:
        expert_in = C.copy_to(expert_in, group)
        e0 = axis_index(mesh, ep_axis) * n_local
        expert_in = expert_in[e0:e0 + n_local]
    dt = torch.promote_types(expert_in.dtype, params["w1"].dtype)
    h = torch.relu(torch.einsum("ecd,edf->ecf", expert_in.to(dt),
                                params["w1"].to(dt)))
    out = torch.einsum("ecf,efd->ecd", h, params["w2"].to(dt))
    return C.gather_from(out, group, 0)


def _sum_tokens(t: torch.Tensor, mesh, token_axes) -> torch.Tensor:
    for axis, _ in token_axes:
        t = C.all_reduce_sum(t, axis_group(mesh, axis))
    return t


def moe_ffn(params: Dict[str, Any], x: torch.Tensor, mesh=None,
            ep_axis: str = "ep", capacity_factor: float = 1.25,
            return_aux: bool = False, dispatch: str = "scatter",
            token_axes: Optional[Sequence[Tuple[str, int]]] = None):
    """Switch-routed expert FFN. ``x`` (..., D) → (..., D), or ``(y,
    aux_loss)`` with ``return_aux``. ``y`` is in the promoted type of x and
    the expert weights (float32 for bfloat16 activations, as in JAX).

    ``token_axes`` (with a mesh): the ``(axis, dim)`` pairs that split x's
    tokens; default dp over dim 0 where the mesh has dp."""
    if dispatch not in ("scatter", "dense"):
        raise ValueError(
            f"dispatch must be 'scatter' or 'dense', got {dispatch!r}")
    if token_axes is None:
        token_axes = (() if mesh is None or "dp" not in mesh.mesh_dim_names
                      else (("dp", 0),))
    if mesh is None:
        token_axes = ()
    lead_shape = tuple(x.shape[:-1])
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    T = xt.shape[0] * math.prod(axis_size(mesh, a) for a, _ in token_axes)
    E = params["wr"].shape[1]
    C_ = max(1, math.ceil(T / E * capacity_factor))

    logits, gate, expert, onehot, pos, keep = _route(
        params, xt, C_, lead_shape, mesh, token_axes)

    if dispatch == "dense":
        keep_e = keep[:, None] * onehot                           # (T, E)
        # all zeros past the capacity, as JAX's one_hot gives
        pos_oh = (pos[:, None] == torch.arange(C_, device=pos.device)).float()
        disp = (keep_e[:, :, None] * pos_oh[:, None, :]).to(xt.dtype)
        expert_in = _sum_tokens(torch.einsum("tec,td->ecd", disp, xt),
                                mesh, token_axes)
        expert_out = _expert_compute(params, expert_in, mesh, ep_axis)
        combine = disp * gate.to(xt.dtype)[:, None, None]
        y = torch.einsum("tec,ecd->td", combine.to(expert_out.dtype),
                         expert_out)
    else:
        # overflow tokens go to row E·C, dropped after the add
        slot = torch.where(keep, expert * C_ + pos,
                           torch.full_like(pos, E * C_))
        buf = xt.new_zeros(E * C_ + 1, D).index_add(0, slot, xt)
        expert_in = _sum_tokens(buf[:E * C_], mesh, token_axes).reshape(
            E, C_, D)
        expert_out = _expert_compute(params, expert_in, mesh, ep_axis)
        flat = expert_out.reshape(E * C_, D)
        gathered = flat[torch.clamp(slot, max=E * C_ - 1)]
        y = gathered * (gate * keep).to(xt.dtype)[:, None]
    y = y.reshape(lead_shape + (D,))
    if return_aux:
        return y, load_balance_loss(logits, expert, mesh, token_axes)
    return y


def load_balance_loss(logits: torch.Tensor, expert: torch.Tensor, mesh=None,
                      token_axes: Sequence[Tuple[str, int]] = ()
                      ) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E × Σ_e (fraction of tokens
    routed to e) × (mean router probability of e) — pushes the router
    toward uniform load. With a mesh, both fractions are over the global
    tokens (summed over ``token_axes``), so every rank holds the same
    value."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, E)
    onehot = F.one_hot(expert.reshape(-1), E).to(probs.dtype)
    n = probs.shape[0]
    if mesh is not None and token_axes:
        n = n * math.prod(axis_size(mesh, a) for a, _ in token_axes)
        tokens = onehot.sum(0)
        for axis, _ in token_axes:
            tokens = C.all_reduce_plain(tokens, axis_group(mesh, axis))
        frac_tokens = tokens / n
        frac_probs = _sum_tokens(probs.sum(0), mesh, token_axes) / n
    else:
        frac_tokens = onehot.mean(dim=0)
        frac_probs = probs.mean(dim=0)
    return (frac_tokens * frac_probs).sum() * E
