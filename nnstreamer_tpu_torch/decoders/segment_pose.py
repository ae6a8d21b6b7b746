"""image_segment + pose_estimation decoders (L4).

The port of nnstreamer_tpu's ``decoders/segment_pose.py``: the host
decode and the rendering are its numpy, copied; its jitted device reduces
are torch here, run where the batch lies.

Reference analogs (ext/nnstreamer/tensor_decoder/):
  * ``tensordec-imagesegment.c`` (665 LoC) — per-pixel class map → colored
    video (tflite-deeplab palette);
  * ``tensordec-pose.c`` (845 LoC) — keypoint heatmaps/coords → skeleton
    drawing.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, TensorsInfo
from ..core.caps import VIDEO_MIME
from .base import Decoder, host_array, register_decoder


def _palette(n: int = 32) -> np.ndarray:
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    pal[0] = 0  # background black
    return pal


@register_decoder
class ImageSegment(Decoder):
    """option1 = format: tflite-deeplab (H,W,C logits) | snpe-deeplab (H,W)
    class ids | snpe-depth (H,W) scalar depth map."""

    MODE = "image_segment"

    FORMATS = ("tflite-deeplab", "snpe-deeplab", "snpe-depth")

    def init(self, options):
        super().init(options)
        self.fmt = self.option(1, "tflite-deeplab")
        # reference tensordec-imagesegment.c: an unknown option1 scheme is
        # a hard init error (expectFail corpus), not a silent deeplab
        if self.fmt not in self.FORMATS:
            raise ValueError(
                f"image_segment: unknown option1 format '{self.fmt}' "
                f"(accepted: {', '.join(self.FORMATS)})")
        # option2 = max class labels except background (reference
        # tensordec-imagesegment.c option2, default 20/Pascal); palette
        # gets one color per class + background
        max_labels = self.option(2)
        if max_labels is not None:
            if int(max_labels) < 1:
                raise ValueError(
                    f"image_segment: option2 (max labels) must be >= 1, "
                    f"got {max_labels}")
            self.pal = _palette(int(max_labels) + 1)
        else:
            self.pal = _palette()

    def _hw(self, in_info: TensorsInfo):
        shape = in_info.specs[0].shape if in_info.specs else None
        if shape is None:
            return None
        s = shape[1:] if len(shape) == 4 else shape
        return s[0], s[1]

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        hw = self._hw(in_info)
        if hw is None:
            return Caps.new(VIDEO_MIME, format="RGB")
        return Caps.new(VIDEO_MIME, format="RGB", width=hw[1], height=hw[0])

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        a = host_array(buf.tensors[0])
        if a.ndim == 4:
            a = a[0]
        if self.fmt == "snpe-depth":
            d = a.astype(np.float32)
            d = (255 * (d - d.min()) / max(float(d.max() - d.min()), 1e-9)).astype(np.uint8)
            return Buffer([np.repeat(d[..., None] if d.ndim == 2 else d, 3, axis=-1)])
        classes = a.argmax(-1) if a.ndim == 3 else a.astype(np.int64)
        return self._render_classes(classes)

    def _render_classes(self, classes: np.ndarray) -> Buffer:
        frame = self.pal[classes % len(self.pal)]
        out = Buffer([frame.astype(np.uint8)])
        out.meta["class_map"] = classes
        return out

    def make_reduce(self, in_info: TensorsInfo):
        """Device stage: the logits volume (B,H,W,C) never leaves the card
        — only the argmax class map (or normalized depth map) crosses to
        the host (C× less traffic)."""
        if self.fmt == "snpe-depth":
            def reduce_depth(ts):
                d = ts[0].float()
                axes = tuple(range(1, d.ndim))
                lo = d.amin(dim=axes, keepdim=True)
                hi = d.amax(dim=axes, keepdim=True)
                return ((255 * (d - lo) / (hi - lo).clamp_min(1e-9))
                        .to(torch.uint8),)
            return reduce_depth

        def reduce_classes(ts):
            a = ts[0]
            if a.ndim >= 4:  # (B,H,W,C) logits → class ids
                # argmax < C: one byte per pixel when it fits (the copy to
                # the host is the whole point of the reduction); the first
                # maximum wins, as in numpy and XLA
                dt = torch.uint8 if a.shape[-1] <= 255 else torch.int32
                return (torch.argmax(a, -1).to(dt),)
            return (a.to(torch.int32),)  # already class ids
        return reduce_classes

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        a = np.asarray(arrays[0])
        if self.fmt == "snpe-depth":
            return Buffer([np.repeat(a[..., None] if a.ndim == 2 else a, 3, axis=-1)])
        return self._render_classes(a.astype(np.int64))


# Default keypoint set: the 14-joint human skeleton the reference ships
# (tensordec-pose.c pose_metadata_default :150-185 — anatomical topology,
# written here in our own structure). Connections are symmetric; draw loops
# emit each edge once (k > i).
_POSE_DEFAULT = [
    ("top", (1,)),
    ("neck", (0, 2, 5, 8, 11)),
    ("r_shoulder", (1, 3)),
    ("r_elbow", (2, 4)),
    ("r_wrist", (3,)),
    ("l_shoulder", (1, 6)),
    ("l_elbow", (5, 7)),
    ("l_wrist", (6,)),
    ("r_hip", (1, 9)),
    ("r_knee", (8, 10)),
    ("r_ankle", (9,)),
    ("l_hip", (1, 12)),
    ("l_knee", (11, 13)),
    ("l_ankle", (12,)),
]

# COCO-17 keypoint set (used when the stream carries 17 keypoints)
_COCO17_LABELS = [
    "nose", "l_eye", "r_eye", "l_ear", "r_ear", "l_shoulder", "r_shoulder",
    "l_elbow", "r_elbow", "l_wrist", "r_wrist", "l_hip", "r_hip", "l_knee",
    "r_knee", "l_ankle", "r_ankle",
]
_EDGES_COCO17 = [
    (0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14), (14, 16),
]


@register_decoder
class PoseEstimation(Decoder):
    """Keypoint heatmaps/coords → skeleton overlay (L4).

    Reference analog: ``tensordec-pose.c`` — same option numbering and
    decode semantics; rendering is this framework's own style.

    option1 = "W:H" output video size (default 320:240);
    option2 = "W:H" input model size (keypoints are scaled input→output
    with the reference's integer math; defaults to the output size;
    the legacy value "heatmap"/"coords" is accepted as a mode alias);
    option3 = keypoint label file, one label per line (default: the
    14-joint skeleton above);
    option4 = mode: "heatmap-only" (default — argmax per keypoint grid,
    reference :765-800), "heatmap-offset" (posenet: sigmoid scores +
    per-cell offset tensor input[1], reference :774-798), or "coords"
    ((K,2|3) normalized x,y[,score] rows — our extension).

    Keypoints with score < 0.5 are invalid and not drawn (reference
    :693-697); decoded keypoints ride in ``meta["keypoints"]`` with
    scores, validity, and labels.
    """

    MODE = "pose_estimation"

    def init(self, options):
        super().init(options)
        wh = self.option(1, "320:240").split(":")
        self.width, self.height = int(wh[0]), int(wh[1])
        opt2 = self.option(2, "")
        self.mode = self.option(4, "heatmap-only")
        if opt2 and ":" not in opt2:
            # legacy API: option2 carried the mode
            self.mode = {"heatmap": "heatmap-only"}.get(opt2, opt2)
            opt2 = ""
        # without an explicit input size the heatmap GRID is normalized to
        # the output frame (legacy behavior); with one, keypoints scale
        # input→output with the reference's integer math
        self._in_size_given = bool(opt2)
        if opt2:
            iwh = opt2.split(":")
            self.in_width, self.in_height = int(iwh[0]), int(iwh[1])
        else:
            self.in_width, self.in_height = self.width, self.height
        if self.mode not in ("heatmap-only", "heatmap-offset", "coords"):
            # reference tensordec-pose.c rejects unknown mode strings at
            # init (expectFail corpus); legacy aliases normalized above
            raise ValueError(
                f"pose_estimation: unknown mode '{self.mode}' (accepted: "
                "heatmap-only, heatmap-offset, coords)")
        self.labels = [n for n, _ in _POSE_DEFAULT]
        self.connections = {i: c for i, (_, c) in enumerate(_POSE_DEFAULT)}
        path = self.option(3)
        if path:
            with open(path) as fh:
                labels = [ln.strip() for ln in fh if ln.strip()]
            if labels:
                self.labels = labels
                if len(labels) != len(_POSE_DEFAULT):
                    self.connections = {}

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        return Caps.new(VIDEO_MIME, format="RGBA", width=self.width, height=self.height)

    def _points_from_coords(self, t: np.ndarray):
        k = t.astype(np.float32).reshape(-1, t.shape[-1])
        xs = np.clip(k[:, 0] * (self.width - 1), 0, self.width - 1)
        ys = np.clip(k[:, 1] * (self.height - 1), 0, self.height - 1)
        scores = k[:, 2] if k.shape[1] > 2 else np.ones(len(k), np.float32)
        pts = np.stack([xs, ys], axis=1).astype(np.int64)
        return pts, scores, scores >= 0.5

    def _scale_from_grid(self, my, mx, gy: int, gx: int, oy=None, ox=None):
        """Grid indices (+ optional posenet offsets) → output-frame px,
        the reference's integer math (tensordec-pose.c :765-800)."""
        if oy is not None:
            posx = mx / max(gx - 1, 1) * self.in_width + ox
            posy = my / max(gy - 1, 1) * self.in_height + oy
            xs = (posx * self.width / self.in_width).astype(np.int64)
            ys = (posy * self.height / self.in_height).astype(np.int64)
        elif not self._in_size_given:
            # legacy normalization: grid corners map to frame corners
            xs = (mx / max(gx - 1, 1) * (self.width - 1)).astype(np.int64)
            ys = (my / max(gy - 1, 1) * (self.height - 1)).astype(np.int64)
        else:
            xs = mx * self.width // self.in_width
            ys = my * self.height // self.in_height
        xs = np.clip(xs, 0, self.width - 1)
        ys = np.clip(ys, 0, self.height - 1)
        return np.stack([xs, ys], axis=1)

    def _decode_points(self, tensors):
        """→ (pts (K,2) int output px, scores (K,), valid (K,) bool)."""
        t = host_array(tensors[0]).astype(np.float32)
        if self.mode == "coords":
            return self._points_from_coords(t)
        a = t[0] if t.ndim == 4 else t  # (gy, gx, K)
        gy, gx, n = a.shape  # decode every channel; labels only name them
        heat = a
        if self.mode == "heatmap-offset":
            heat = 1.0 / (1.0 + np.exp(-heat))
        flat = heat.reshape(-1, n)
        idx = flat.argmax(0)  # first max in (gy, gx) scan order, like the ref
        scores = flat[idx, np.arange(n)]
        my, mx = np.unravel_index(idx, (gy, gx))
        oy = ox = None
        if self.mode == "heatmap-offset":
            if len(tensors) < 2:
                raise ValueError(
                    "pose_estimation: heatmap-offset needs a second tensor "
                    "of per-cell offsets (gy, gx, 2K); got a single-tensor "
                    "frame — mux the offsets stream or use heatmap-only")
            off = host_array(tensors[1]).astype(np.float32)
            off = off[0] if off.ndim == 4 else off  # (gy, gx, 2K)
            oy = off[my, mx, np.arange(n)]
            ox = off[my, mx, n + np.arange(n)]
        pts = self._scale_from_grid(my, mx, gy, gx, oy, ox)
        return pts, scores, scores >= 0.5

    def make_reduce(self, in_info: TensorsInfo):
        """Device stage: heatmap argmax + score/offset gather where the
        batch lies — only (B,K) index/score rows cross to the host instead
        of the full heatmap (and offset) volumes."""
        if self.mode == "coords":  # already tiny; batch the pull anyway
            return lambda ts: (ts[0].float(),)

        offset = self.mode == "heatmap-offset"

        def reduce(ts):
            t = ts[0].float()  # (B, gy, gx, K)
            b, gy, gx, n = t.shape
            flat = t.reshape(b, gy * gx, n)
            idx = torch.argmax(flat, dim=1)  # (B, K) first-max scan order
            b_ix = torch.arange(b, device=t.device)[:, None]
            k_ix = torch.arange(n, device=t.device)[None, :]
            raw = flat[b_ix, idx, k_ix]
            scores = torch.sigmoid(raw) if offset else raw
            my = torch.div(idx, gx, rounding_mode="floor").to(torch.int32)
            mx = (idx % gx).to(torch.int32)
            outs = [my, mx, scores.float()]
            if offset:
                if len(ts) < 2:
                    raise ValueError(
                        "pose_estimation: heatmap-offset needs a second "
                        "tensor of per-cell offsets (gy, gx, 2K)")
                off = ts[1].float().reshape(b, gy * gx, 2 * n)
                outs.append(off[b_ix, idx, k_ix])
                outs.append(off[b_ix, idx, n + k_ix])
            # grid dims ride along per frame — scaling must not depend on
            # negotiated specs (flexible streams have none)
            outs.append(torch.tensor([gy, gx], dtype=torch.int32,
                                     device=t.device).expand(b, 2))
            return tuple(outs)
        return reduce

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        if self.mode == "coords":
            pts, scores, valid = self._points_from_coords(np.asarray(arrays[0]))
            return self._render(pts, scores, valid)
        my, mx, scores = (np.asarray(a) for a in arrays[:3])
        gy, gx = (int(v) for v in np.asarray(arrays[-1]))
        oy = ox = None
        if self.mode == "heatmap-offset":
            oy, ox = np.asarray(arrays[3]), np.asarray(arrays[4])
        pts = self._scale_from_grid(my.astype(np.int64), mx.astype(np.int64),
                                    gy, gx, oy, ox)
        return self._render(pts, scores, scores >= 0.5)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        pts, scores, valid = self._decode_points(buf.tensors)
        return self._render(pts, scores, valid)

    def _render(self, pts, scores, valid) -> Buffer:
        frame = np.zeros((self.height, self.width, 4), np.uint8)
        n = len(pts)
        default_labels = self.labels == [nm for nm, _ in _POSE_DEFAULT]
        if n == 17 and default_labels:
            # COCO keypoint set, not the 14-joint default skeleton:
            # edges AND names switch together (label file overrides both)
            edges = _EDGES_COCO17
            labels = _COCO17_LABELS
        else:
            edges = [(i, k) for i, conns in self.connections.items()
                     for k in conns if i < k < n]
            labels = self.labels
        for a, b in edges:
            if a < n and b < n and valid[a] and valid[b]:
                _draw_line(frame, pts[a], pts[b], (255, 255, 0, 255))
        for i, (x, y) in enumerate(pts):
            if valid[i]:
                frame[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = (0, 255, 0, 255)
        out = Buffer([frame])
        out.meta["keypoints"] = [
            {"x": int(x), "y": int(y), "score": float(s), "valid": bool(v),
             "label": labels[i] if i < len(labels) else str(i)}
            for i, ((x, y), s, v) in enumerate(zip(pts, scores, valid))
        ]
        return out


def _draw_line(frame: np.ndarray, p0, p1, color) -> None:
    n = int(max(abs(int(p1[0]) - int(p0[0])), abs(int(p1[1]) - int(p0[1])), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).astype(np.int64)
    ys = np.linspace(p0[1], p1[1], n + 1).astype(np.int64)
    frame[ys, xs] = color
