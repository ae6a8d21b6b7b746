"""Pipeline parallelism for training: the GPipe microbatch schedule over a
``pp`` mesh axis.

The port of nnstreamer_tpu's ``parallel/pipeline.py``, with its schedule:
with P stages and M microbatches the program runs M + P − 1 ticks; at tick
t stage s runs microbatch m = t − s, and every tick the activations hop
one stage along the ring (``collectives.permute``, whose backward is the
inverse hop). Bubble ticks compute on zeros and are masked, as in the
reference, so every rank's backward runs every hop in the same order. The
last stage's outputs are masked in and summed over ``pp`` so every rank
holds them; as in the reference every rank then computes the same loss.

Differentiable end to end: the gradient of the stacked parameters is the
whole one on every rank (each stage's slice is all-gathered over ``pp`` in
the backward), as ``jax.grad`` of the reference's ``run`` gives.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from . import collectives as C
from ..utils.tree import tree_map
from .mesh import axis_group, axis_index, axis_size


def stack_stage_params(params_list: Sequence[Any]) -> Any:
    """Stack per-stage parameter trees along a leading stage axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def mesh_from_assignment(assignment, num_stages: int, axis: str = "pp",
                         devices=None):
    """The ``pp`` mesh of a stage → rank assignment: stage ``s`` runs on
    rank ``devices[assignment[s]]`` (``devices`` defaults to the world's
    ranks). ``assignment`` is a sequence of distinct indices, one per
    stage, or a ``runtime.placement.PlacementPlan`` (its stage order is the
    pipeline's). Every rank calls this together."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .mesh import _device_type

    if hasattr(assignment, "stages"):  # a PlacementPlan
        assignment = [st.device for st in assignment.stages]
    assignment = [int(i) for i in assignment]
    if len(assignment) != num_stages:
        raise ValueError(
            f"pipeline: assignment has {len(assignment)} stages, "
            f"expected {num_stages}")
    if len(set(assignment)) != num_stages:
        raise ValueError(
            f"pipeline: assignment {assignment} reuses a device — GPipe "
            "stages need one chip each (params + activations resident)")
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    for i in assignment:
        if not 0 <= i < len(devices):
            raise ValueError(
                f"pipeline: assignment index {i} out of range "
                f"({len(devices)} devices)")
    ranks = torch.tensor([devices[i] for i in assignment], dtype=torch.int64)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=(axis,))


class _StageSlice(torch.autograd.Function):
    """This stage's slice of a stacked leaf; backward gathers every
    stage's slice gradient into the whole stacked gradient."""

    @staticmethod
    def forward(ctx, stacked, stage, group):
        ctx.group, ctx.stage, ctx.shape = group, stage, stacked.shape
        return stacked[stage].clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.group is None:
            out = g.new_zeros(ctx.shape)
            out[ctx.stage] = g
            return out, None, None
        return C.all_gather_plain(g[None], ctx.group, 0), None, None


def make_pipeline(stage_fn: Callable, num_stages: int, mesh=None,
                  axis: str = "pp", assignment=None,
                  devices=None) -> Callable:
    """Build ``run(stacked_params, microbatches) -> outputs``.

    * ``stage_fn(stage_params, x) -> y`` — one stage's forward, shapes
      preserved (y feeds the next stage);
    * ``stacked_params`` — leaves with leading axis ``num_stages`` (see
      stack_stage_params), the same on every rank; each rank runs the
      slice of its stage;
    * ``microbatches`` — (M, mb, ...) input, the same on every rank;
    * returns (M, mb, ...) final-stage outputs on every rank.

    Stage → rank mapping comes from ``mesh`` (its ``axis``) OR
    ``assignment`` (see :func:`mesh_from_assignment`); exactly one."""
    if (mesh is None) == (assignment is None):
        raise ValueError("pipeline: pass exactly one of mesh= or "
                         "assignment= (a hand mesh OR a planner-produced "
                         "stage->device assignment)")
    if assignment is not None:
        mesh = mesh_from_assignment(assignment, num_stages, axis=axis,
                                    devices=devices)
    if axis not in (mesh.mesh_dim_names or ()) or (
            axis_size(mesh, axis) != num_stages):
        shape = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
        raise ValueError(
            f"pipeline: mesh axis '{axis}' size must equal num_stages "
            f"({num_stages}); mesh has {shape}")
    group = axis_group(mesh, axis)
    stage = axis_index(mesh, axis)
    last = num_stages - 1

    def run(stacked_params, xs: torch.Tensor) -> torch.Tensor:
        M = xs.shape[0]
        params = tree_map(lambda p: _StageSlice.apply(p, stage, group),
                           stacked_params)
        xs = C.copy_to(xs, group)
        zeros = torch.zeros_like(xs[0])
        prev_out, ys = zeros, torch.zeros_like(xs)
        for t in range(M + num_stages - 1):
            # activations hop to the next stage; stage 0 takes its
            # microbatch instead (its receive is unused but kept in the
            # graph, so its backward hop runs on every rank)
            recv = C.permute(prev_out, group, -1)
            m = t - stage
            m_idx = min(max(m, 0), M - 1)
            valid = 0 <= m < M
            inp = torch.where(torch.tensor(stage == 0, device=xs.device),
                              xs[m_idx], recv)
            out = torch.where(torch.tensor(valid, device=xs.device),
                              stage_fn(params, inp), zeros)
            write = torch.zeros(M, dtype=xs.dtype, device=xs.device)
            if valid and stage == last:
                write[m_idx] = 1
            ys = ys + write.reshape((M,) + (1,) * (xs.dim() - 1)) * out[None]
            prev_out = out
        # only the last stage's ys is real: every rank gets its sum
        return C.reduce_from(ys, group)

    return run
