"""Non-maximum suppression and box utilities (decoder post-processing).

The port of nnstreamer_tpu's ``ops/nms.py``. Reference analog: the
NMS/IoU logic embedded in
``ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c`` (consts
DETECTION_THRESHOLD/IOU 0.5 etc., :138-141). Two implementations:

* ``nms_numpy`` — host-side greedy NMS, a verbatim copy of
  nnstreamer_tpu's, used by the decoders (box counts are tiny; the host
  wins over a device round trip);
* ``nms_torch`` — the same greedy sweep as torch ops on the tensors'
  device, with a fixed-size result, for keeping NMS beside a model that
  already runs on the card (nnstreamer_tpu's ``nms_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_IOU_THRESHOLD = 0.5
DEFAULT_SCORE_THRESHOLD = 0.25


def _iou_broadcast(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of every box in ``a`` against every box in ``b`` (broadcasting:
    a is (...,1,4)-shaped against b (N,4) or both (N,4) via outer axes).
    Single home of the intersection/union/eps-guard arithmetic."""
    ay1, ax1, ay2, ax2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    by1, bx1, by2, bx2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    a_area = np.maximum(ay2 - ay1, 0) * np.maximum(ax2 - ax1, 0)
    b_area = np.maximum(by2 - by1, 0) * np.maximum(bx2 - bx1, 0)
    iy1 = np.maximum(ay1, by1)
    ix1 = np.maximum(ax1, bx1)
    iy2 = np.minimum(ay2, by2)
    ix2 = np.minimum(ax2, bx2)
    inter = np.maximum(iy2 - iy1, 0) * np.maximum(ix2 - ix1, 0)
    union = a_area + b_area - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU for (N,4) [ymin,xmin,ymax,xmax] boxes."""
    return _iou_broadcast(boxes[:, None, :], boxes[None, :, :])


def nms_numpy(boxes: np.ndarray, scores: np.ndarray,
              iou_threshold: float = DEFAULT_IOU_THRESHOLD,
              score_threshold: float = DEFAULT_SCORE_THRESHOLD,
              max_out: int = 100) -> np.ndarray:
    """Greedy NMS; returns indices of kept boxes (descending score).

    IoU rows are computed lazily per KEPT box (O(N*K), K <= max_out)
    instead of materializing the full N^2 matrix; same kept set.
    """
    keep_mask = scores >= score_threshold
    idx = np.flatnonzero(keep_mask)
    if idx.size == 0:
        return idx
    order = idx[np.argsort(-scores[idx])]
    b = boxes[order]
    kept = []
    suppressed = np.zeros(order.size, bool)
    for i in range(order.size):
        if suppressed[i]:
            continue
        kept.append(order[i])
        if len(kept) >= max_out:
            break
        rest = slice(i + 1, None)
        suppressed[rest] |= _iou_broadcast(b[i], b[rest]) > iou_threshold
    return np.asarray(kept, dtype=np.int64)


def nms_torch(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float = DEFAULT_IOU_THRESHOLD,
              score_threshold: float = DEFAULT_SCORE_THRESHOLD,
              max_out: int = 100):
    """Fixed-size greedy NMS where the tensors lie: returns
    ``(indices (max_out,) int64, valid (max_out,) bool)``, the kept boxes'
    indices in descending score order, -1 past the last.

    The sweep visits the boxes in descending score (a stable sort, so
    equal scores keep index order) and keeps each one that is still alive
    and above ``score_threshold``; a kept box kills every later box whose
    IoU with it exceeds ``iou_threshold``. The IoU matrix is built once;
    the sweep itself stays on the device (no per-box host sync)."""
    n = boxes.shape[0]
    kept = torch.full((max_out,), -1, dtype=torch.int64, device=boxes.device)
    if n == 0:
        return kept, kept >= 0
    boxes = boxes.float()
    scores = scores.float()
    s, order = torch.sort(scores, descending=True, stable=True)
    b = boxes[order]
    y1, x1, y2, x2 = b.unbind(-1)
    area = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    inter = (iy2 - iy1).clamp_min(0) * (ix2 - ix1).clamp_min(0)
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp_min(1e-9),
                      torch.zeros_like(union))
    kill = iou > iou_threshold
    alive = s >= score_threshold
    count = torch.zeros((), dtype=torch.int64, device=boxes.device)
    slots = torch.arange(max_out, device=boxes.device)
    for i in range(n):
        ok = alive[i] & (count < max_out)
        kept = torch.where(ok & (slots == count), order[i], kept)
        count = count + ok.to(torch.int64)
        alive = alive & ~(kill[i] & ok)
        alive[i] = False
    return kept, slots < count
