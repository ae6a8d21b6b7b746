"""Operations and bytes of the work, counted from shapes, and the peaks.

The counts come from the model's shapes (a configuration file) or from
the ``.tflite`` file itself, never from the program, so they stay the
same whatever later implements the work. A multiply-add is two
operations. A bound counts each input byte read once and each output
byte written once, in the type the model states, so that no
implementation can beat it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .tflite_reader import Graph

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAKS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float8": 1979e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "float32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def mobilenet_v2_macs(cfg: Dict) -> int:
    """Multiply-adds of one frame's forward: every convolution and the
    classifier (batch norm, activations, sums and the pool not counted)."""
    h, w, c = cfg["frame"]
    total = 0

    def conv(cin, cout, k, s, groups=1):
        nonlocal h, w, total
        h, w = -(-h // s), -(-w // s)
        total += h * w * cout * (cin // groups) * k * k

    conv(c, cfg["stem_channels"], 3, 2)
    cin = cfg["stem_channels"]
    for t, cout, n, s in cfg["bottlenecks"]:
        for i in range(n):
            hidden = cin * t
            if t != 1:
                conv(cin, hidden, 1, 1)
            conv(hidden, hidden, 3, s if i == 0 else 1, groups=hidden)
            conv(hidden, cout, 1, 1)
            cin = cout
    conv(cin, cfg["head_channels"], 1, 1)
    return total + cfg["head_channels"] * cfg["num_classes"]


def tflite_launches(graph: Graph, batch: int) -> Dict[str, List[Tuple[float, int]]]:
    """(operations, bytes) of each op of one forward at ``batch``, by the
    kind of kernel that serves it: ``gemm`` for CONV_2D, FULLY_CONNECTED
    and MEAN, ``depthwise`` for DEPTHWISE_CONV_2D. Bytes: the int8
    input and output, the int8 weights and the int32 bias."""
    out: Dict[str, List[Tuple[float, int]]] = {"gemm": [], "depthwise": []}
    for op in graph.ops:
        x = graph.tensors[op.inputs[0]]
        y = graph.tensors[op.outputs[0]]
        n_in = batch * int(np.prod(x.shape[1:]))
        n_out = batch * int(np.prod(y.shape[1:]))
        if op.op in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            wt, b = graph.tensors[op.inputs[1]], graph.tensors[op.inputs[2]]
            if op.op == "CONV_2D":
                _, kh, kw, cin = wt.shape
                macs = n_out * kh * kw * cin
            elif op.op == "DEPTHWISE_CONV_2D":
                _, kh, kw, _ = wt.shape
                macs = n_out * kh * kw
            else:
                macs = n_out * wt.shape[1]
            nbytes = n_in + n_out + int(np.prod(wt.shape)) + 4 * int(np.prod(b.shape))
            kind = "depthwise" if op.op == "DEPTHWISE_CONV_2D" else "gemm"
            out[kind].append((2.0 * macs, nbytes))
        elif op.op == "MEAN":
            out["gemm"].append((float(n_in), n_in + n_out))
    return out


def bound_s(launches: List[Tuple[float, int]], peak: float) -> float:
    """The least time the launches could take: for each, the larger of its
    bytes at the memory's rate and its operations at ``peak``."""
    return sum(max(b / HBM_BYTES_PER_S, ops / peak) for ops, b in launches)
