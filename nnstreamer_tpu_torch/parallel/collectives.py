"""Differentiable collectives of the parallel layer.

GSPMD derives each collective's transpose by itself; here each one is a
``torch.autograd.Function`` with its backward written out. Two gradient
conventions meet in the layer:

* over ``dp``, ``sp`` and ``pp`` every rank holds part of the data and the
  objective is the SUM of the ranks' local losses: ``all_reduce_sum``'s
  backward all-reduces, ``all_gather_sum``'s sums the gathered gradient
  and keeps this rank's block;
* over ``tp`` every rank holds the same activations and computes the same
  loss (Megatron's convention): ``copy_to`` (identity forward, all-reduce
  backward) opens a tensor-parallel region, ``reduce_from`` (all-reduce
  forward, identity backward) and ``gather_from`` (all-gather forward,
  this rank's block backward) close it.

``permute`` (ring rotation; its backward is the inverse rotation) and
``all_to_all`` (equal chunks on dim 0; its own adjoint) are permutations and
hold under both. Every function returns its input unchanged when ``group``
is None (no mesh, or an axis the mesh lacks).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out, dim=dim)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = _size(group), _rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim), None, None


class _AllGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(_reduce(g, ctx.group), ctx.group, ctx.dim), None, None


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Rank j receives rank (j + shift) % n's ``x``."""
    n, r = _size(group), _rank(group)
    if n == 1 or shift % n == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    src = dist.get_global_rank(group, (r + shift) % n)
    dst = dist.get_global_rank(group, (r - shift) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for q in reqs:
        q.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -ctx.shift), None, None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; backward all-reduces (summed-loss convention)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a tensor-parallel region: identity, all-reduce backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave a tensor-parallel region by summing the ranks' partials."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Leave a tensor-parallel region by concatenating the ranks' blocks
    along ``dim``; backward keeps this rank's block."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


def all_gather_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the ranks' blocks along ``dim``; backward sums the
    gradient over the ranks and keeps this rank's block."""
    return x if group is None else _AllGatherSum.apply(x, group, dim)


def permute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Ring rotation: rank j gets rank (j + shift) % n's tensor."""
    return x if group is None else _Permute.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s dim 0 in n equal chunks: chunk j goes to rank j, and
    chunk i of the result came from rank i."""
    return x if group is None else _AllToAll.apply(x, group)


def all_gather_plain(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather outside autograd (routing bookkeeping, parameters)."""
    return x if group is None else _gather(x, group, dim)


def all_reduce_plain(x: torch.Tensor, group,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce over ``group`` outside autograd (a sum, or ``op``), in
    place; returns ``x``."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x
