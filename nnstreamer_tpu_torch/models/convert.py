"""Weight converters: nnstreamer_tpu's parameter pytrees → the port's.

Both take the JAX package's parameters as numpy arrays (``np.asarray`` of
each leaf; bfloat16 leaves are accepted by their dtype name) and return
tensors on ``device``:

* ``params_from_jax`` — the transformer's parameter dict. The two layouts
  are the same (models/transformer.py), so no leaf is transposed.
* ``mobilenet_params_from_flax`` — the MobileNet-v2 flax tree as a state
  dict of models/mobilenet_v2.py's ``MobileNetV2``, with the kernels
  transposed to torch's layouts.
* ``ssd_params_from_flax``, ``posenet_params_from_flax`` and
  ``deeplab_params_from_flax`` — the zoo's flax trees as state dicts of
  models/{ssd_mobilenet,posenet,deeplab}.py (the heads' ``nn.Conv``
  layers carry a bias);
* ``builtin_params_from_jax`` — the weights nnstreamer_tpu's
  ``builtin://matmul`` and ``builtin://mlp`` draw from ``jax.random``,
  as the ``weights`` of the torch backend's ``make_builtin``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..utils.hw_accel import resolve_device

_BLOCK_KEYS = ("ln1", "wqkv", "wo", "ln2")
_FFN_KEYS = ("w1", "w2")
_MOE_KEYS = ("wr", "w1", "w2")


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
    ln2, w1, w2}, ...]} as numpy arrays; an MoE block holds ``moe``: {wr
    (D, E), w1 (E, D, F), w2 (E, F, D)} in place of w1 and w2. ``dtype``
    casts the floating leaves (e.g. torch.bfloat16 for serving); None
    keeps theirs."""
    device = resolve_device(device)
    blocks = []
    for i, blk in enumerate(tree["blocks"]):
        ffn, keys = ((blk["moe"], _MOE_KEYS) if "moe" in blk
                     else (blk, _FFN_KEYS))
        missing = ([k for k in _BLOCK_KEYS if k not in blk]
                   + [k for k in keys if k not in ffn])
        if missing:
            raise KeyError(f"block {i} lacks {missing}")
        out = {k: _tensor(blk[k], device, dtype) for k in _BLOCK_KEYS}
        moved = {k: _tensor(ffn[k], device, dtype) for k in keys}
        if "moe" in blk:
            out["moe"] = moved
        else:
            out.update(moved)
        blocks.append(out)
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


def conv_params_from_flax(node: Dict[str, Any],
                          device: Optional[Union[str, torch.device]] = None,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, torch.Tensor]:
    """One flax ``nn.Conv`` with a bias — kernel (kh, kw, in, out), bias
    (out,) — as the state dict of models/_blocks.py's ``Conv``."""
    device = resolve_device(device)
    return {"weight": _tensor(np.transpose(np.asarray(node["kernel"]),
                                           (3, 2, 0, 1)), device, dtype),
            "bias": _tensor(node["bias"], device, dtype)}


def _add(out: Dict[str, torch.Tensor], prefix: str,
         part: Dict[str, torch.Tensor]) -> None:
    for name, t in part.items():
        out[f"{prefix}.{name}"] = t


def _trunk_params(p: Dict[str, Any], n_blocks: int, device, dtype
                  ) -> Dict[str, torch.Tensor]:
    """The stem (ConvBnRelu_0) and InvertedResidual_0..n-1 of a zoo trunk
    as ``stem.*`` and ``blocks.{i}.*``."""
    out: Dict[str, torch.Tensor] = {}
    _add(out, "stem", convbnrelu_params_from_flax(p["ConvBnRelu_0"], device,
                                                  dtype))
    for i in range(n_blocks):
        _add(out, f"blocks.{i}", inverted_residual_params_from_flax(
            p[f"InvertedResidual_{i}"], device, dtype))
    return out


def _check_leaves(p: Dict[str, Any], out: Dict[str, torch.Tensor],
                  name: str) -> Dict[str, torch.Tensor]:
    total = _count_leaves(p)
    if len(out) != total:
        raise KeyError(f"the flax tree has {total} leaves; the {name} "
                       f"layout uses {len(out)}")
    return out


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
    n_blocks = sum(k.startswith("InvertedResidual_") for k in p)
    out = _trunk_params(p, n_blocks, device, dtype)
    _add(out, "head", convbnrelu_params_from_flax(p["ConvBnRelu_1"], device,
                                                  dtype))
    dense = p["Dense_0"]
    out["fc.weight"] = _tensor(np.asarray(dense["kernel"]).T, device, dtype)
    out["fc.bias"] = _tensor(dense["bias"], device, dtype)
    return _check_leaves(p, out, "MobileNet-v2")


def ssd_params_from_flax(tree: Dict[str, Any],
                         device: Optional[Union[str, torch.device]] = None,
                         dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
    """nnstreamer_tpu's ``build_ssd_mobilenet`` parameters, ``{"params":
    {Backbone_0: {ConvBnRelu_0 (stem), InvertedResidual_0..9,
    ConvBnRelu_1 (the stride-64 layer)}, Conv_0..7}}``: Conv_2i is the
    location head and Conv_2i+1 the class head of feature map i. Raises
    KeyError when a leaf is missing or left over."""
    device = resolve_device(device)
    p = tree["params"] if "params" in tree else tree
    bb = p["Backbone_0"]
    out = _trunk_params(bb, 10, device, dtype)
    _add(out, "extra", convbnrelu_params_from_flax(bb["ConvBnRelu_1"],
                                                   device, dtype))
    for i in range(4):
        _add(out, f"loc_heads.{i}", conv_params_from_flax(
            p[f"Conv_{2 * i}"], device, dtype))
        _add(out, f"conf_heads.{i}", conv_params_from_flax(
            p[f"Conv_{2 * i + 1}"], device, dtype))
    return _check_leaves(p, out, "SSD-MobileNet")


def posenet_params_from_flax(tree: Dict[str, Any],
                             device: Optional[Union[str, torch.device]] = None,
                             dtype: Optional[torch.dtype] = None
                             ) -> Dict[str, torch.Tensor]:
    """nnstreamer_tpu's ``build_posenet`` parameters, ``{"params":
    {ConvBnRelu_0 (stem), InvertedResidual_0..6, Conv_0 (the heatmap
    head)}}``."""
    device = resolve_device(device)
    p = tree["params"] if "params" in tree else tree
    out = _trunk_params(p, 7, device, dtype)
    _add(out, "head", conv_params_from_flax(p["Conv_0"], device, dtype))
    return _check_leaves(p, out, "PoseNet")


def deeplab_params_from_flax(tree: Dict[str, Any],
                             device: Optional[Union[str, torch.device]] = None,
                             dtype: Optional[torch.dtype] = None
                             ) -> Dict[str, torch.Tensor]:
    """nnstreamer_tpu's ``build_deeplab`` parameters, ``{"params":
    {ConvBnRelu_0 (stem), InvertedResidual_0..8, ConvBnRelu_1..3 (the
    ASPP branches: 1×1, dilated 6, dilated 12), ConvBnRelu_4 (the
    image-pooling branch), ConvBnRelu_5 (the fuse), Conv_0 (the
    classifier)}}``."""
    device = resolve_device(device)
    p = tree["params"] if "params" in tree else tree
    out = _trunk_params(p, 9, device, dtype)
    for i in range(3):
        _add(out, f"aspp.{i}", convbnrelu_params_from_flax(
            p[f"ConvBnRelu_{i + 1}"], device, dtype))
    _add(out, "pool_proj", convbnrelu_params_from_flax(p["ConvBnRelu_4"],
                                                       device, dtype))
    _add(out, "fuse", convbnrelu_params_from_flax(p["ConvBnRelu_5"], device,
                                                  dtype))
    _add(out, "classifier", conv_params_from_flax(p["Conv_0"], device, dtype))
    return _check_leaves(p, out, "DeepLab")


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
