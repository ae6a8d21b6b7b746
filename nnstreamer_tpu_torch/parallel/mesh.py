"""Device meshes for the port's SPMD parallel layer.

nnstreamer_tpu expresses dp/tp/sp as ``jax.sharding`` over one ``Mesh`` and
lets GSPMD place the collectives. The port runs one process per card
(``torch.distributed``: NCCL on the card, gloo on the CPU) and writes each
collective out; a mesh here is a ``torch.distributed.DeviceMesh`` over the
world's ranks with the package's axis names.

Axis conventions used across the package:
  * ``dp``  — data/batch parallel
  * ``tp``  — tensor/model parallel (attention heads, mlp hidden, experts)
  * ``sp``  — sequence/context parallel (long-context activations)

``axis_size``, ``axis_index`` and ``axis_group`` read a mesh axis; an axis
the mesh lacks (or no mesh at all) has size 1, index 0 and no group, so the
collectives of the parallel layer are skipped on it. An axis of size 1 in
the mesh keeps its group, and its collectives run (a copy each).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

AXES = ("dp", "tp", "sp")


def factor_devices(n: int, want: Sequence[str] = AXES) -> Dict[str, int]:
    """Factor ``n`` devices into mesh axis sizes, preferring dp ≥ tp ≥ sp.

    8 -> {dp:2, tp:2, sp:2}; 4 -> {dp:2, tp:2, sp:1}; 6 -> {dp:3, tp:2, sp:1};
    prime n lands entirely on dp.
    """
    sizes = {a: 1 for a in want}
    order = list(want)
    # strip prime factors, largest first, round-robin over the axes
    factors: List[int] = []
    m = n
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    factors.sort(reverse=True)
    for i, f in enumerate(factors):
        sizes[order[i % len(order)]] *= f
    return sizes


def _device_type() -> str:
    """The device type of the default process group's backend: NCCL
    groups run on the card, gloo groups on the CPU."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(devices: Optional[Sequence[int]] = None,
              axis_sizes: Optional[Dict[str, int]] = None):
    """A ``DeviceMesh`` over ``devices`` (ranks; default every rank of the
    initialized default process group) with the package's axis names.

    Known axes keep the dp-outermost order (dp spans hosts, tp/sp stay on
    one host's links) whatever the caller's dict order; custom axes ("pp",
    "ep", ...) follow in insertion order. Every rank of the world calls
    this together (it creates one process group per axis)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(parallel.init_multihost)")
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    sizes = axis_sizes or factor_devices(len(devices))
    axes = tuple([a for a in AXES if a in sizes]
                 + [a for a in sizes if a not in AXES])
    shape = tuple(sizes[a] for a in axes)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh {sizes} does not cover {len(devices)} devices")
    ranks = torch.tensor(devices, dtype=torch.int64).reshape(shape)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axes)


def mesh_device(mesh, device=None):
    """The device of this rank's tensors under ``mesh``: its card (the
    current CUDA device, which ``init_multihost`` set) under NCCL, the CPU
    under gloo. A ``device`` the caller asked for must be of that type —
    a meshed stage never runs on another device than its process group's
    — and the mesh then picks the card."""
    import torch

    want = "cuda" if mesh.device_type == "cuda" else "cpu"
    if device is not None and torch.device(device).type != want:
        raise ValueError(
            f"device {device} does not match the mesh's process group, "
            f"which runs on {want} (NCCL on the card, gloo on the CPU)")
    if want == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of ``axis`` holding this rank, or None where
    there is no mesh or it lacks the axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)
