"""Sharded inference over the local cards (data parallel in one process).

The port of nnstreamer_tpu's ``parallel/shard.py``. The reference jits a
model callable with its batch sharded over a mesh's ``dp`` axis; here one
process keeps a replica per card: ``ShardedRunner`` splits the batch into
equal blocks, runs the callable on each block on its own card (the
launches of one card do not wait for another's) and gathers the outputs
on the first.

    runner = ShardedRunner(fn)            # every local card
    out = runner(batch)                   # batch split across them

``fn`` runs on each block where the block lies, so it must not pin a
device of its own.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch


class ShardedRunner:
    def __init__(self, fn: Callable, devices: Optional[Sequence] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ShardedRunner: no CUDA device; pass devices=['cpu', ...] "
                    "to split over CPU replicas")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.fn = fn
        self.devices = [torch.device(d) for d in devices]

    @property
    def batch_divisor(self) -> int:
        return len(self.devices)

    def __call__(self, batch) -> Any:
        batch = torch.as_tensor(batch)
        n = self.batch_divisor
        if batch.shape[0] % n:
            raise ValueError(
                f"batch {batch.shape[0]} not divisible by dp={n} "
                f"(pad upstream with tensor_aggregator)")
        blocks = batch.chunk(n, dim=0)
        outs = [self.fn(b.to(d, non_blocking=True))
                for b, d in zip(blocks, self.devices)]
        return torch.cat([o.to(self.devices[0]) for o in outs], dim=0)
