"""Parallelism layer: device meshes, sharded runners, context parallelism,
expert and pipeline parallelism — SPMD over ``torch.distributed``, one
process per card.

The port of nnstreamer_tpu's ``parallel`` package: dp/tp over a mesh
(`mesh.py`, `shard.py`, models/transformer.py), sp/cp via ring attention
and Ulysses (`context.py`), experts (`moe.py`), GPipe (`pipeline.py`),
with every collective and its backward in `collectives.py`.
"""
from .mesh import AXES, factor_devices, make_mesh
from .multihost import global_mesh, init_multihost, process_info
from .shard import ShardedRunner
from .context import (
    make_context_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "AXES",
    "factor_devices",
    "make_mesh",
    "ShardedRunner",
    "global_mesh",
    "init_multihost",
    "process_info",
    "make_context_attention",
    "ring_attention",
    "ulysses_attention",
]
