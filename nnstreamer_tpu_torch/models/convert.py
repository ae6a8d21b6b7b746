"""Weight converter: nnstreamer_tpu's parameter pytree → the port's.

``params_from_jax`` takes the JAX package's transformer parameters as numpy
arrays (``np.asarray`` of each leaf; bfloat16 leaves are accepted by their
dtype name) and returns the port's parameter dict on ``device``. The two
layouts are the same (models/transformer.py), so no leaf is transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..utils.hw_accel import resolve_device

_BLOCK_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def _tensor(a, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy extension type: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def params_from_jax(tree: Dict[str, Any],
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """``tree``: {"embed", "pos", "out_norm", "blocks": [{ln1, wqkv, wo,
    ln2, w1, w2}, ...]} as numpy arrays. ``dtype`` casts the floating
    leaves (e.g. torch.bfloat16 for serving); None keeps theirs."""
    device = resolve_device(device)
    blocks = []
    for i, blk in enumerate(tree["blocks"]):
        if "moe" in blk:
            raise ValueError(f"block {i}: MoE blocks are not ported yet")
        missing = [k for k in _BLOCK_KEYS if k not in blk]
        if missing:
            raise KeyError(f"block {i} lacks {missing}")
        blocks.append({k: _tensor(blk[k], device, dtype) for k in _BLOCK_KEYS})
    return {"embed": _tensor(tree["embed"], device, dtype),
            "pos": _tensor(tree["pos"], device, dtype),
            "out_norm": _tensor(tree["out_norm"], device, dtype),
            "blocks": blocks}
