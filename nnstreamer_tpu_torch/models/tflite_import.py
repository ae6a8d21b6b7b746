"""The two helpers of nnstreamer_tpu's ``models/tflite_import.py`` that the
model zoo's blocks use: TF/tflite "SAME" padding made explicit, and the
depthwise convolution. The ``.tflite`` importer itself is not in this
package yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def explicit_padding(h: int, w: int, kh: int, kw: int, strides, dilation,
                     padding: str):
    """tflite ComputePadding: (out_h, out_w, ((top, bottom), (left, right)))
    — SAME splits the total with the extra row/col at the END (the TF/XLA
    convention; torch's symmetric ``padding=`` would shift every stride-2
    layer by one pixel)."""
    sh, sw = strides
    dh, dw = dilation
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        pt = max((oh - 1) * sh + ekh - h, 0)
        pl = max((ow - 1) * sw + ekw - w, 0)
        return oh, ow, ((pt // 2, pt - pt // 2), (pl // 2, pl - pl // 2))
    oh, ow = (h - ekh) // sh + 1, (w - ekw) // sw + 1
    return oh, ow, ((0, 0), (0, 0))


def conv2d_same(x: torch.Tensor, w: torch.Tensor, strides, dilation,
                groups: int = 1, padding: str = "SAME") -> torch.Tensor:
    """``F.conv2d`` of an NCHW (or channels_last) ``x`` with the TF padding
    of :func:`explicit_padding`: symmetric padding goes to the convolution
    itself, asymmetric padding is applied first with ``F.pad``."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    _, _, ((pt, pb), (pl, pr)) = explicit_padding(
        int(x.shape[2]), int(x.shape[3]), kh, kw, strides, dilation, padding)
    if pt == pb and pl == pr:
        return F.conv2d(x, w, None, strides, (pt, pl), dilation, groups)
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, None, strides, 0, dilation, groups)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, strides, padding: str,
                   dilation) -> torch.Tensor:
    """Depthwise convolution with the meaning of nnstreamer_tpu's
    ``depthwise_shift_add``: output channel ``o`` is input channel
    ``o // mult`` (tflite's c*mult + m order) weighted by ``w[o, 0]``.

    ``x`` is (N, C, H, W); ``w`` is (C*mult, 1, kh, kw) — tflite's
    [1, kh, kw, C*mult] is ``w.permute(3, 0, 1, 2)`` of it."""
    return conv2d_same(x, w, strides, dilation, groups=int(x.shape[1]),
                       padding=padding)
