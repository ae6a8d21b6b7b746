"""Weight converters: nnstreamer_tpu's parameter pytrees → the port's.

Both take the JAX package's parameters as numpy arrays (``np.asarray`` of
each leaf; bfloat16 leaves are accepted by their dtype name) and return
tensors on ``device``:

* ``params_from_jax`` — the transformer's parameter dict. The two layouts
  are the same (models/transformer.py), so no leaf is transposed.
* ``mobilenet_params_from_flax`` — the MobileNet-v2 flax tree as a state
  dict of models/mobilenet_v2.py's ``MobileNetV2``, with the kernels
  transposed to torch's layouts.
* ``builtin_params_from_jax`` — the weights nnstreamer_tpu's
  ``builtin://matmul`` and ``builtin://mlp`` draw from ``jax.random``,
  as the ``weights`` of the torch backend's ``make_builtin``.
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


def convbnrelu_params_from_flax(node: Dict[str, Any],
                                device: Optional[Union[str, torch.device]] = None,
                                dtype: Optional[torch.dtype] = None
                                ) -> Dict[str, torch.Tensor]:
    """One flax ``ConvBnRelu`` as the state dict of models/_blocks.py's
    ``ConvBnRelu``. A conv kernel (kh, kw, in, out) and a depthwise kernel
    (kh, kw, 1, C) both become (out, in, kh, kw)."""
    device = resolve_device(device)
    kernel = (node["depthwise_kernel"] if "depthwise_kernel" in node
              else node["Conv_0"]["kernel"])
    return {"weight": _tensor(np.transpose(np.asarray(kernel), (3, 2, 0, 1)),
                              device, dtype),
            "bn_scale": _tensor(node["bn_scale"], device, dtype),
            "bn_bias": _tensor(node["bn_bias"], device, dtype)}


def inverted_residual_params_from_flax(node: Dict[str, Any],
                                       device: Optional[Union[str, torch.device]] = None,
                                       dtype: Optional[torch.dtype] = None
                                       ) -> Dict[str, torch.Tensor]:
    """One flax ``InvertedResidual`` — ConvBnRelu_0..2 (expand, depthwise,
    project), or ConvBnRelu_0..1 without an expansion — as the state dict
    of models/_blocks.py's ``InvertedResidual``."""
    parts = (("expand", "dw", "project") if "ConvBnRelu_2" in node
             else ("dw", "project"))
    out = {}
    for k, part in enumerate(parts):
        for name, t in convbnrelu_params_from_flax(
                node[f"ConvBnRelu_{k}"], device, dtype).items():
            out[f"{part}.{name}"] = t
    return out


def _count_leaves(node) -> int:
    if isinstance(node, dict):
        return sum(_count_leaves(v) for v in node.values())
    return 1


def mobilenet_params_from_flax(tree: Dict[str, Any],
                               device: Optional[Union[str, torch.device]] = None,
                               dtype: Optional[torch.dtype] = None
                               ) -> Dict[str, torch.Tensor]:
    """``tree``: nnstreamer_tpu's ``build_mobilenet_v2`` parameters,
    ``{"params": {ConvBnRelu_0 (stem), InvertedResidual_0..16,
    ConvBnRelu_1 (head), Dense_0}}`` (the outer "params" level optional).
    An InvertedResidual holds ConvBnRelu_0..2 (expand, depthwise,
    project), or ConvBnRelu_0..1 when it has no expansion. Dense (in, out)
    becomes torch's (out, in). ``dtype`` casts every leaf; None keeps
    theirs. Raises KeyError when a leaf is missing or left over."""
    device = resolve_device(device)
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}
    for part, node in (("stem", p["ConvBnRelu_0"]), ("head", p["ConvBnRelu_1"])):
        for name, t in convbnrelu_params_from_flax(node, device, dtype).items():
            out[f"{part}.{name}"] = t
    i = 0
    while f"InvertedResidual_{i}" in p:
        for name, t in inverted_residual_params_from_flax(
                p[f"InvertedResidual_{i}"], device, dtype).items():
            out[f"blocks.{i}.{name}"] = t
        i += 1
    dense = p["Dense_0"]
    out["fc.weight"] = _tensor(np.asarray(dense["kernel"]).T, device, dtype)
    out["fc.bias"] = _tensor(dense["bias"], device, dtype)
    total = _count_leaves(p)
    if len(out) != total:
        raise KeyError(f"the flax tree has {total} leaves; the MobileNet-v2 "
                       f"layout uses {len(out)}")
    return out


def builtin_params_from_jax(name: str, arrays: Dict[str, Any],
                            device: Optional[Union[str, torch.device]] = None
                            ) -> Dict[str, torch.Tensor]:
    """nnstreamer_tpu's builtin weights → ``make_builtin(weights=...)``.

    ``matmul``: {"w": (n, n)}, ``jax.random.normal(PRNGKey(0), (n, n))``.
    ``mlp``: {"w_in": (features, n), "w": [(n, n)] * layers, "w_out":
    (n, 1)}, drawn from PRNGKey(layers + 1), PRNGKey(i) and PRNGKey(layers
    + 2); the hidden list becomes ``w0``.. in order. Same layouts (x @ w)
    on both sides, so nothing is transposed."""
    device = resolve_device(device)
    if name == "matmul":
        return {"w": _tensor(arrays["w"], device, torch.float32)}
    if name == "mlp":
        out = {"w_in": _tensor(arrays["w_in"], device, torch.float32),
               "w_out": _tensor(arrays["w_out"], device, torch.float32)}
        for i, w in enumerate(arrays["w"]):
            out[f"w{i}"] = _tensor(w, device, torch.float32)
        return out
    raise ValueError(f"builtin '{name}' has no weights (matmul, mlp do)")
