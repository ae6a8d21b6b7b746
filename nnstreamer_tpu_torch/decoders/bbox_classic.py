"""Reference-exact bounding-box decode + render ("classic" style).

The port of nnstreamer_tpu's ``decoders/bbox_classic.py``: host numpy,
copied as it is.

The default :class:`~.bounding_boxes.BoundingBoxes` rendering is this
framework's own design (per-class colors, thickness-2 overlay). This module
is the byte-compatible re-implementation of the reference decoder's output
semantics — ``ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c`` —
so a pipeline switched over from the reference produces the *identical
RGBA bytes* its golden tests expect (nnstreamer_tpu's copy is proven
against the reference's own fixture corpus in
``tests/test_reference_parity.py``):

* integer box coordinates in input-image space with C float→int
  truncation (``_get_object_i_mobilenet_ssd`` :1473-1509, ``bb_decode``
  yolo branches :2023-2135, ``_get_objects_mp_palm_detection`` :1726-1770,
  ``_get_objects_mobilenet_ssd_pp`` :1628-1661);
* greedy NMS over integer pixel boxes with the reference's +1-inclusive
  intersection (``iou``/``nms`` :1559-1614), descending-probability order;
* 1-pixel 0xFF0000FF outlines mapped output←input by integer division,
  and 8×13 label-text cells advancing 9 px starting at the box's x1
  (``draw`` :1783-1869) — glyph pixels come from this framework's own
  font (the reference embeds a third-party SGI bitmap font we deliberately
  do not reproduce; cell GEOMETRY matches exactly, so everything outside
  text cells is byte-identical);
* centroid tracking with first-frame id assignment and least-distance
  matching (``update_centroids`` :1299-1456).

All arithmetic that feeds a float→int truncation is kept in float32 to
match the C code's ``gfloat`` domain.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

PIXEL = np.array([255, 0, 0, 255], np.uint8)  # 0xFF0000FF RGBA
CHAR_W, CHAR_H, CHAR_ADVANCE = 8, 13, 9
LABEL_RAISE = 14  # label band drawn at max(0, y1 - 14)
G_MINFLOAT = np.float32(1.1754943508222875e-38)
MOBILENET_SSD_DETECTION_MAX = 2034


@dataclass
class DetObject:
    """detectedObject analog: integer pixel box in input-image space."""

    class_id: int
    x: int
    y: int
    width: int
    height: int
    prob: float
    tracking_id: int = 0


def _trunc(a: np.ndarray) -> np.ndarray:
    """C ``(int)`` cast: truncate toward zero. NaN/inf from corrupted
    streams cast to INT32_MIN garbage without warnings/raises — the
    decode path stays total (chaos-tested); garbage boxes draw nothing."""
    with np.errstate(invalid="ignore"):
        return np.asarray(a, np.float32).astype(np.int32)


# ---------------------------------------------------------------------------
# per-mode parsing → List[DetObject]

def load_priors_txt(path: str) -> np.ndarray:
    """Reference box-prior file: ≥4 lines of space/tab/comma-separated
    floats → (4, N) float32 rows [ycenter, xcenter, h, w]."""
    rows = []
    with open(path) as fh:
        lines = fh.read().split("\n")
    for row in range(4):
        vals = [w for w in lines[row].replace(",", " ").replace("\t", " ").split(" ") if w]
        rows.append(np.array(vals, np.float64).astype(np.float32)[: MOBILENET_SSD_DETECTION_MAX + 1])
    n = min(len(r) for r in rows)
    return np.stack([r[:n] for r in rows])


def parse_mobilenet_ssd(
    boxes: np.ndarray,
    dets: np.ndarray,
    priors: np.ndarray,
    i_w: int,
    i_h: int,
    threshold: float = 0.5,
    scales: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0),
    class_select: str = "last",
) -> List[DetObject]:
    """Raw SSD heads: boxes (N,4) center offsets, dets (N,C) logits,
    priors (4,N) [cy,cx,h,w].

    ``class_select``: the two reference variants of the same macro —
    ``"last"`` for bounding_boxes (missing ``highscore`` update, last
    above-threshold class wins) and ``"first"`` for tensor_region
    (``break`` after the first above-threshold class,
    tensordec-tensor_region.c:436-476)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1])
    dets = np.asarray(dets, np.float32).reshape(boxes.shape[0], -1)
    n = min(len(boxes), MOBILENET_SSD_DETECTION_MAX, priors.shape[1])
    y_scale, x_scale, h_scale, w_scale = (np.float32(s) for s in scales)
    # threshold compared in logit domain (sigmoid_threshold = logit(thr))
    with np.errstate(divide="ignore"):
        sig_thr = np.float32(np.log(threshold / (1.0 - threshold))) if 0.0 < threshold < 1.0 else (
            np.float32(-np.inf) if threshold <= 0.0 else np.float32(np.inf))
    out: List[DetObject] = []
    cls_logits = dets[:n, 1:]  # class 0 (background) never scanned
    valid = cls_logits >= sig_thr
    any_valid = valid.any(axis=1)
    # the reference's `highscore` guard is never updated (tensordec-
    # boundingbox.c:1475,1496 — `highscore = score` is absent), so every
    # above-threshold class overwrites the result: the LAST above-threshold
    # class index wins, not the argmax. Goldens encode this behavior.
    ncls = cls_logits.shape[1]
    if class_select == "first":
        best = np.argmax(valid, axis=1)
    else:
        best = ncls - 1 - np.argmax(valid[:, ::-1], axis=1)
    for d in np.nonzero(any_valid)[0]:
        c = int(best[d]) + 1
        score = np.float32(1.0) / (np.float32(1.0) + np.exp(-dets[d, c]))
        yc = boxes[d, 0] / y_scale * priors[2, d] + priors[0, d]
        xc = boxes[d, 1] / x_scale * priors[3, d] + priors[1, d]
        h = np.exp(boxes[d, 2] / h_scale) * priors[2, d]
        w = np.exp(boxes[d, 3] / w_scale) * priors[3, d]
        ymin = yc - h / np.float32(2)
        xmin = xc - w / np.float32(2)
        out.append(DetObject(
            class_id=c,
            x=max(0, int(_trunc(xmin * np.float32(i_w)))),
            y=max(0, int(_trunc(ymin * np.float32(i_h)))),
            width=int(_trunc(w * np.float32(i_w))),
            height=int(_trunc(h * np.float32(i_h))),
            prob=float(score),
        ))
    return out


def parse_ssd_pp(
    num: np.ndarray,
    classes: np.ndarray,
    scores: np.ndarray,
    boxes: np.ndarray,
    i_w: int,
    i_h: int,
    threshold: float = float(G_MINFLOAT),
) -> List[DetObject]:
    """Post-processed SSD: num (1,), classes (N,), scores (N,),
    boxes (N,4) [ymin,xmin,ymax,xmax] normalized."""
    classes = np.asarray(classes, np.float32).reshape(-1)
    scores = np.asarray(scores, np.float32).reshape(-1)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    thr = np.float32(threshold)
    # clamp the model-reported count to what the tensors actually hold
    n = min(int(np.asarray(num).reshape(-1)[0]),
            len(classes), len(scores), len(boxes))
    out: List[DetObject] = []
    one = np.float32(1)
    zero = np.float32(0)
    for d in range(n):
        if scores[d] < thr:
            continue
        x1 = min(max(boxes[d, 1], zero), one)
        y1 = min(max(boxes[d, 0], zero), one)
        x2 = min(max(boxes[d, 3], zero), one)
        y2 = min(max(boxes[d, 2], zero), one)
        out.append(DetObject(
            class_id=int(classes[d]),
            x=int(_trunc(x1 * np.float32(i_w))),
            y=int(_trunc(y1 * np.float32(i_h))),
            width=int(_trunc((x2 - x1) * np.float32(i_w))),
            height=int(_trunc((y2 - y1) * np.float32(i_h))),
            prob=float(scores[d]),
        ))
    return out


def parse_yolo(
    a: np.ndarray,
    i_w: int,
    i_h: int,
    num_info: int,
    conf_threshold: float = 0.25,
    scaled_output: bool = False,
) -> List[DetObject]:
    """yolov5 (num_info=5: cx,cy,w,h,obj,cls…) / yolov8 (num_info=4)."""
    a = np.asarray(a, np.float32).reshape(-1, a.shape[-1])
    thr = np.float32(conf_threshold)
    cls = a[:, num_info:]
    # corrupted streams carry NaN/inf: NaN probs compare False against the
    # threshold (row skipped); inf coordinates truncate to garbage boxes
    # that draw nothing — either way the decode stays total (chaos-tested)
    with np.errstate(invalid="ignore", over="ignore"):
        max_conf = cls.max(axis=1) if cls.size else np.zeros(len(a), np.float32)
        max_idx = cls.argmax(axis=1) if cls.size else np.zeros(len(a), np.int64)
        prob = max_conf * a[:, 4] if num_info == 5 else max_conf
        out: List[DetObject] = []
        fw, fh = np.float32(i_w), np.float32(i_h)
        for d in np.nonzero(prob > thr)[0]:
            cx, cy, w, h = a[d, 0], a[d, 1], a[d, 2], a[d, 3]
            if not scaled_output:
                cx, cy, w, h = cx * fw, cy * fh, w * fw, h * fh
            out.append(DetObject(
                class_id=int(max_idx[d]),
                x=int(_trunc(max(np.float32(0), cx - w / np.float32(2)))),
                y=int(_trunc(max(np.float32(0), cy - h / np.float32(2)))),
                width=int(_trunc(min(fw, w))),
                height=int(_trunc(min(fh, h))),
                prob=float(prob[d]),
            ))
    return out


def parse_palm(
    boxes: np.ndarray,
    scores: np.ndarray,
    anchors: np.ndarray,
    i_w: int,
    i_h: int,
    threshold: float = 0.5,
) -> List[DetObject]:
    """mediapipe palm: boxes (A,18), scores (A,); offsets scaled by the
    input-image size (reference divides by i_width/i_height, NOT 192)."""
    boxes = np.asarray(boxes, np.float32).reshape(len(anchors), -1)
    raw = np.asarray(scores, np.float32).reshape(-1)
    thr = np.float32(threshold)
    # clamp ±100 in float32, sigmoid via double exp (C `exp`), cast back
    clamped = np.minimum(np.maximum(raw, np.float32(-100)), np.float32(100))
    sig = (1.0 / (1.0 + np.exp(-clamped.astype(np.float64)))).astype(np.float32)
    fw, fh = np.float32(i_w), np.float32(i_h)
    out: List[DetObject] = []
    for d in np.nonzero(sig >= thr)[0]:
        ax, ay, aw, ah = anchors[d]
        yc = boxes[d, 0] / fh * ah + ay
        xc = boxes[d, 1] / fw * aw + ax
        h = boxes[d, 2] / fh * ah
        w = boxes[d, 3] / fw * aw
        out.append(DetObject(
            class_id=0,
            x=max(0, int(_trunc((xc - w / np.float32(2)) * fw))),
            y=max(0, int(_trunc((yc - h / np.float32(2)) * fh))),
            width=int(_trunc(w * fw)),
            height=int(_trunc(h * fh)),
            prob=float(sig[d]),
        ))
    return out


def parse_ov(a: np.ndarray, i_w: int, i_h: int,
             threshold: float = 0.8) -> List[DetObject]:
    """ov-person/face: (N,7) rows [image_id,label,conf,x1,y1,x2,y2]."""
    a = np.asarray(a, np.float32).reshape(-1, 7)
    out: List[DetObject] = []
    for row in a:
        if int(row[0]) < 0:
            break
        if row[2] < np.float32(threshold):
            continue
        out.append(DetObject(
            class_id=-1,
            x=int(_trunc(row[3] * np.float32(i_w))),
            y=int(_trunc(row[4] * np.float32(i_h))),
            width=int(_trunc((row[5] - row[3]) * np.float32(i_w))),
            height=int(_trunc((row[6] - row[4]) * np.float32(i_h))),
            prob=1.0,
        ))
    return out


# ---------------------------------------------------------------------------
# NMS + tracking

def iou_classic(a: DetObject, b: DetObject) -> float:
    """+1-inclusive integer intersection (reference ``iou`` :1559).

    Scalar spec of the math ``nms_classic`` vectorizes; kept as the
    readable reference (nnstreamer_tpu cross-checks it against the
    vectorized sweep in tests/test_reference_parity.py, TestNmsSpec)."""
    x1 = max(a.x, b.x)
    y1 = max(a.y, b.y)
    x2 = min(a.x + a.width, b.x + b.width)
    y2 = min(a.y + a.height, b.y + b.height)
    w = max(0, x2 - x1 + 1)
    h = max(0, y2 - y1 + 1)
    inter = float(w * h)
    union = float(a.width * a.height) + float(b.width * b.height) - inter
    o = inter / union if union else 0.0
    return o if o >= 0 else 0.0


def nms_classic(results: List[DetObject], threshold: float) -> List[DetObject]:
    """Greedy suppress (strictly) above-threshold IoU, high prob first.

    Pairwise IoU is vectorized (float64 keeps the small-integer pixel
    arithmetic exact); only the inherently sequential greedy sweep loops.
    """
    results = sorted(results, key=lambda r: -r.prob)
    n = len(results)
    if n == 0:
        return results
    x = np.array([r.x for r in results], np.int64)
    y = np.array([r.y for r in results], np.int64)
    w = np.array([r.width for r in results], np.int64)
    h = np.array([r.height for r in results], np.int64)
    ix = np.minimum(x[:, None] + w[:, None], x[None, :] + w[None, :]) \
        - np.maximum(x[:, None], x[None, :]) + 1
    iy = np.minimum(y[:, None] + h[:, None], y[None, :] + h[None, :]) \
        - np.maximum(y[:, None], y[None, :]) + 1
    inter = np.maximum(ix, 0) * np.maximum(iy, 0)
    area = (w * h).astype(np.float64)
    union = area[:, None] + area[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union != 0, inter / union, 0.0)
    iou = np.maximum(iou, 0.0)
    valid = np.ones(n, bool)
    for i in range(n):
        if valid[i]:
            kill = iou[i, i + 1:] > threshold
            valid[i + 1:] &= ~kill
    return [r for r, v in zip(results, valid) if v]


@dataclass
class _Centroid:
    id: int
    cx: int
    cy: int
    disappeared: int = 0
    matched: Optional[int] = None


@dataclass
class CentroidTracker:
    """Reference ``update_centroids`` (:1299): nearest-centroid matching
    with consecutive-disappearance expiry; ids start at 1.

    Like the reference, a matched centroid's stored position is NOT moved
    to the new detection (only creation sets cx/cy) — stale-anchor
    matching is part of the behavior being reproduced.
    """

    max_num: int = 100
    disappear_threshold: int = 100
    last_id: int = 0
    centroids: List[_Centroid] = field(default_factory=list)

    def update(self, boxes: List[DetObject]) -> None:
        if len(boxes) > self.max_num:
            return
        self.centroids = [c for c in self.centroids
                          if c.disappeared < self.disappear_threshold]
        if len(self.centroids) > self.max_num:
            return
        if not boxes:
            for c in self.centroids:
                c.disappeared += 1
            return
        if not self.centroids:
            for i, b in enumerate(boxes):
                self.last_id += 1
                self.centroids.append(_Centroid(
                    self.last_id, b.x + b.width // 2, b.y + b.height // 2))
                b.tracking_id = self.last_id
            return
        dist = []
        for i, c in enumerate(self.centroids):
            c.matched = None
            for j, b in enumerate(boxes):
                bcx, bcy = b.x + b.width // 2, b.y + b.height // 2
                d = (c.cx - bcx) ** 2 + (c.cy - bcy) ** 2
                dist.append((d, i, j))
        dist.sort(key=lambda t: t[0])
        for _, ci, bj in dist:
            c, b = self.centroids[ci], boxes[bj]
            if b.tracking_id != 0 or c.matched is not None:
                continue
            c.matched = bj
            b.tracking_id = c.id
            c.disappeared = 0
        for c in self.centroids:
            if c.matched is None:
                c.disappeared += 1
        for j, b in enumerate(boxes):
            if b.tracking_id == 0:
                self.last_id += 1
                self.centroids.append(_Centroid(
                    self.last_id, b.x + b.width // 2, b.y + b.height // 2))
                b.tracking_id = self.last_id


# ---------------------------------------------------------------------------
# drawing

@lru_cache(maxsize=None)
def _glyph_cell(ch: str) -> np.ndarray:
    """(13,8) bool cell for one character, from this framework's 5×7 font
    (reference geometry: full cell overwritten; glyph pixels differ from
    the reference's unreproduced third-party font). Cached — the glyph
    set is tiny and this sits on the per-frame render path."""
    from .font import _glyph_bitmap

    cell = np.zeros((CHAR_H, CHAR_W), bool)
    cell[3:10, 1:6] = _glyph_bitmap(ch).astype(bool)
    cell.setflags(write=False)  # cached and shared across callers
    return cell


def draw_classic(
    results: List[DetObject],
    out_w: int,
    out_h: int,
    i_w: int,
    i_h: int,
    labels: Optional[List[str]] = None,
    track: bool = False,
) -> Tuple[np.ndarray, List[Dict]]:
    """Render per reference ``draw`` (:1783): 1px PIXEL_VALUE outlines on
    transparent black, label cells at (x1, y1-14). Returns (frame RGBA,
    label-cell rects [{'x','y'} 8×13 each]) — the cell list lets parity
    tests mask glyph pixels, the one deliberate divergence."""
    frame = np.zeros((out_h, out_w, 4), np.uint8)
    use_label = bool(labels)
    cells: List[Dict] = []
    for a in results:
        if use_label and (a.class_id < 0 or a.class_id >= len(labels)):
            continue
        # the reference does not clamp x/y below (its C pointer arithmetic
        # is simply out of bounds for malformed detections); clamping to the
        # frame is a strict robustification — identical for in-frame boxes
        x1 = max(0, out_w * a.x // i_w)
        x2 = min(out_w - 1, out_w * (a.x + a.width) // i_w)
        y1 = max(0, out_h * a.y // i_h)
        y2 = min(out_h - 1, out_h * (a.y + a.height) // i_h)
        if x1 <= x2 and y1 <= y2 and x1 < out_w and y1 < out_h:
            frame[y1, x1:x2 + 1] = PIXEL
            frame[y2, x1:x2 + 1] = PIXEL
            if y2 > y1 + 1:
                frame[y1 + 1:y2, x1] = PIXEL
                frame[y1 + 1:y2, x2] = PIXEL
        if use_label:
            label = labels[a.class_id]
            if track:
                label = f"{label}-{a.tracking_id}"
            yl = max(0, y1 - LABEL_RAISE)
            if yl + CHAR_H > out_h:  # label band off-frame: skip (ref UB)
                continue
            xl = x1
            for ch in label:
                if xl + CHAR_W > out_w:
                    break
                cell = _glyph_cell(ch)
                frame[yl:yl + CHAR_H, xl:xl + CHAR_W] = np.where(
                    cell[:, :, None], PIXEL, np.zeros(4, np.uint8))
                cells.append({"x": xl, "y": yl})
                xl += CHAR_ADVANCE
    return frame, cells


def mask_label_cells(frame: np.ndarray, cells: List[Dict]) -> np.ndarray:
    """Zero the 8×13 label-text cells (for glyph-agnostic comparison)."""
    out = frame.copy()
    for c in cells:
        out[c["y"]:c["y"] + CHAR_H, c["x"]:c["x"] + CHAR_W] = 0
    return out
