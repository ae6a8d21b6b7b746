"""bounding_boxes decoder: detections → video overlay (L4).

The port of nnstreamer_tpu's ``decoders/bounding_boxes.py``: the host
parse, the classic path and the overlay are its numpy, copied; its jitted
device reduce is torch here, run where the batch lies.

Reference analog: ``ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c``
(2292 LoC, 9 box formats at :157-203). Supported modes here (option1):

  * ``mobilenet-ssd-postprocess`` (aka ``tf-ssd``): tensors
    [boxes (N,4) norm ymin,xmin,ymax,xmax; scores (N,) or (N,C)];
  * ``mobilenet-ssd``: RAW head tensors [locations (N,4) center-variance
    offsets; class logits (N,C)] + a prior-box file (option7, ``.npy``
    (N,4) [cy,cx,h,w] — the reference's box_priors.txt role); sigmoid
    scores, anchors decoded on host via models.ssd_mobilenet.decode_boxes_np;
  * ``yolov5``: (N, 5+C) rows [cx,cy,w,h,obj,cls...] (pixels or normalized);
  * ``yolov8``: (4+C, N) or (N, 4+C) rows [cx,cy,w,h,cls...];
  * ``ov-person-detection`` / ``ov-face-detection``: one tensor of
    (N, 7) rows [image_id, label, conf, xmin, ymin, xmax, ymax]
    (normalized); rows end at the first negative image_id; confidence
    threshold 0.8, no NMS (the model already applies it) — reference
    ``_get_persons_ov`` (tensordec-boundingbox.c:1675) and the caps check
    [7, 200] (:1172-1188);
  * ``mp-palm-detection``: tensors [boxes (N,18), scores (N,)] against
    SSD-style anchors generated for the 192×192 palm model (reference
    ``_mp_palm_detection_generate_anchors`` :673-755); sigmoid scores
    clamped to ±100, anchor-relative decode, NMS IoU 0.05
    (:1726-1770, :2160);
  * ``custom``: a registered python callback (register_bbox_parser).

Options — THE REFERENCE'S NUMBERING (tensordec-boundingbox.c:30-103):
option2 = label file; option3 = mode-dependent values exactly as the
reference documents them (yolo "scaled[:conf[:iou]]", raw ssd
"priors[:thresh[:yscale[:xscale[:hscale[:wscale[:iou]]]]]]" — priors may
be the reference's box_priors.txt text format or ``.npy`` (N,4)
[cy,cx,h,w] —, ssd-postprocess "loc:cls:score:num,thresh%%", mp-palm
"score[:layers:min:max:xoff:yoff:strides...]"); option4 = "W:H" output
video size; option5 = "W:H" model input size; option6 = track (0|1:
centroid tracking, reference option6); option7 = log results.

option8 (the slot the reference reserves for Box Style) selects the
rendering: ``overlay`` (default — this framework's design: per-class
colors, thickness-2 boxes) or ``classic`` — the reference decoder's
byte-compatible output (1px 0xFF0000FF outlines, integer coordinate
math, 8×13 label cells; see ``bbox_classic.py``), proven against the
reference's own golden fixtures in ``tests/test_reference_parity.py``.
option9 = our yolov8 tensor-layout override (auto|boxes-first|
coords-first).

Output: RGBA video frame with box rectangles drawn (transparent background,
to be alpha-blended over the source video — the reference's ``compositor``
pattern); decoded detections also ride in ``buf.meta["detections"]``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import Buffer, Caps, TensorsInfo
from ..core.caps import VIDEO_MIME
from ..ops.nms import nms_numpy
from .base import Decoder, host_array, register_decoder, top_k

_custom_parsers: Dict[str, Callable] = {}


def _log_detections(fmt, dets) -> None:
    """reference option7 (log result bounding boxes)."""
    from ..utils.log import logger

    logger.info("bounding_boxes[%s]: %d detection(s): %s", fmt, len(dets),
                dets)


def register_bbox_parser(name: str, fn: Callable) -> None:
    """fn(tensors) -> (boxes (N,4) normalized [ymin,xmin,ymax,xmax], scores
    (N,), classes (N,))."""
    _custom_parsers[name] = fn


@register_decoder
class BoundingBoxes(Decoder):
    MODE = "bounding_boxes"

    def init(self, options):
        """Reference option numbering (tensordec-boundingbox.c:30-103):
        option1 mode, option2 label file, option3 mode-dependent values,
        option4 output W:H, option5 model-input W:H, option6 track,
        option7 log. option8 (the reference's reserved Box Style slot) is
        ``overlay`` (default) | ``classic`` (reference-byte-compatible
        rendering); option9 is our yolov8 tensor-layout override
        (auto | boxes-first | coords-first — auto transposes when the
        first dim is smaller, right for real (84, 8400) heads but
        ambiguous when N < 4+C)."""
        super().init(options)
        self.fmt = self.option(1, "mobilenet-ssd-postprocess")
        self.labels: List[str] = []
        path = self.option(2)
        if path:
            with open(path) as fh:
                self.labels = [ln.strip() for ln in fh if ln.strip()]
        wh = self.option(4, "320:240").split(":")
        self.width, self.height = int(wh[0]), int(wh[1])
        in_wh = self.option(5, "192:192").split(":")
        self.in_width, self.in_height = int(in_wh[0]), int(in_wh[1])
        self.track = self.option(6, "0") not in ("0", "", "false")
        self.log_results = self.option(7, "0") not in ("0", "", "false")
        self.style = self.option(8, "overlay")
        self.layout = self.option(9, "auto")
        # option10 (our extension): device-path candidate cap before NMS
        # (DEVICE_TOPK default). Exposed because the cap silently changes
        # results when a scene has more above-threshold candidates than
        # it keeps — decode_reduced warns when that happens.
        self.device_topk = int(self.option(10, str(self.DEVICE_TOPK)))
        if self.device_topk < 1:
            raise ValueError(
                f"bounding_boxes: option10 (device top-k) must be >= 1, "
                f"got {self.device_topk}")
        self._topk_warned = False
        self._apply_mode_option3(self.option(3))
        self._tracker = None
        if self.style == "classic" and self.track:
            from . import bbox_classic as bc

            self._tracker = bc.CentroidTracker()
        if self.fmt == "mp-palm-detection":
            self.palm_anchors = _palm_anchors(self._palm_param, self.in_width)

    def _apply_mode_option3(self, opt3: Optional[str]) -> None:
        """option3 carries the mode-dependent values exactly as the
        reference documents them (thresholds, priors, tensor mapping,
        anchor generation)."""
        from . import bbox_classic as bc

        parts = (opt3 or "").split(":")

        def part(i, default=""):
            return parts[i] if i < len(parts) and parts[i] != "" else default

        self.use_nms = True
        self.yolo_scaled = False
        self.anchors = None
        self.ssd_pp_indices = (0, 1, 2, 3)  # num:classes:scores:locations
        self._palm_param: Optional[str] = None
        fmt = self.fmt
        if fmt in ("yolov5", "yolov8"):
            # "scaled[:conf[:iou]]" — defaults 0, 0.25, 0.45
            self.yolo_scaled = part(0, "0") not in ("0", "", "false")
            self.score_threshold = float(part(1, "0.25"))
            self.iou_threshold = float(part(2, "0.45"))
        elif fmt in ("mobilenet-ssd", "tflite-ssd"):
            # "priors.txt[:thresh[:yscale[:xscale[:hscale[:wscale[:iou]]]]]]"
            priors = part(0)
            if not priors:
                raise ValueError(
                    "bounding_boxes: mobilenet-ssd (raw) needs "
                    "option3=<box-priors file>")
            if priors.endswith(".npy"):
                self.anchors = np.load(priors).astype(np.float32)
            else:
                # reference text format, rows [cy, cx, h, w] → (N, 4)
                self.anchors = bc.load_priors_txt(priors).T
            self.score_threshold = float(part(1, "0.5"))
            self.ssd_scales = (float(part(2, "10.0")), float(part(3, "10.0")),
                               float(part(4, "5.0")), float(part(5, "5.0")))
            self.iou_threshold = float(part(6, "0.5"))
        elif fmt in ("mobilenet-ssd-postprocess", "tf-ssd"):
            # "%i:%i:%i:%i,%i" — locations:classes:scores:num , thresh%
            self.score_threshold = float(bc.G_MINFLOAT) \
                if self.style == "classic" else 0.25
            self.iou_threshold = 0.5
            if opt3:
                head, _, thresh = opt3.partition(",")
                idx = head.split(":")
                if len(idx) == 4:
                    loc, cls, score, num = (int(v) for v in idx)
                    self.ssd_pp_indices = (num, cls, score, loc)
                if thresh.strip():
                    self.score_threshold = float(thresh) / 100.0
        elif fmt == "mp-palm-detection":
            # "score[:layers:min:max:xoff:yoff:strides...]"
            self.score_threshold = float(part(0, "0.5"))
            self.iou_threshold = 0.05
            if len(parts) > 1:
                self._palm_param = ":".join(parts[1:])
        elif fmt in ("ov-person-detection", "ov-face-detection"):
            # fixed 0.8 confidence gate, no NMS (model output already
            # suppressed — OV_PERSON_DETECTION_CONF_THRESHOLD)
            self.score_threshold = 0.8
            self.iou_threshold = 0.5
            self.use_nms = False
        else:  # custom-registered parsers: generic defaults
            self.score_threshold = float(part(0, "0.25"))
            self.iou_threshold = float(part(1, "0.5"))

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        return Caps.new(VIDEO_MIME, format="RGBA", width=self.width, height=self.height)

    # -- per-format parsing → normalized boxes ------------------------------
    def _parse(self, tensors) -> tuple:
        fmt = self.fmt
        if fmt in ("mobilenet-ssd", "tflite-ssd"):  # tflite-ssd = old name
            from ..models.ssd_mobilenet import decode_boxes_np

            loc = host_array(tensors[0]).reshape(-1, 4).astype(np.float32)
            logits = host_array(tensors[1]).astype(np.float32)
            logits = logits.reshape(loc.shape[0], -1)
            boxes = decode_boxes_np(
                loc, self.anchors,
                variances=tuple(1.0 / sc for sc in self.ssd_scales))
            scores = 1.0 / (1.0 + np.exp(-logits))  # sigmoid
            classes = scores.argmax(-1)
            return boxes, scores.max(-1), classes
        if fmt in ("ov-person-detection", "ov-face-detection"):
            a = host_array(tensors[0]).astype(np.float32).reshape(-1, 7)
            # rows: [image_id, label, conf, xmin, ymin, xmax, ymax]; the
            # detection list terminates at the first negative image_id
            end = np.nonzero(a[:, 0] < 0)[0]
            if end.size:
                a = a[: end[0]]
            boxes = a[:, [4, 3, 6, 5]]  # -> [ymin, xmin, ymax, xmax]
            # class_id = -1 in the reference (no label set for ov modes)
            classes = np.full(a.shape[0], -1, np.int64)
            return boxes, a[:, 2], classes
        if fmt == "mp-palm-detection":
            anchors = self.palm_anchors  # (A, 4) [x_center, y_center, w, h]
            raw = host_array(tensors[0]).astype(np.float32).reshape(-1, 18)
            scores = host_array(tensors[1]).astype(np.float32).reshape(-1)
            if len(raw) != len(anchors) or len(scores) != len(anchors):
                raise ValueError(
                    f"mp-palm-detection: {len(raw)} box rows / {len(scores)} "
                    f"scores vs {len(anchors)} anchors — check option5 "
                    "(model input size) and option3 (anchor params)"
                )
            n = len(anchors)
            anc = anchors
            clipped = np.clip(scores.astype(np.float64), -100.0, 100.0)
            scores = (1.0 / (1.0 + np.exp(-clipped))).astype(np.float32)
            # anchor-relative decode: offsets scaled by the model input size
            yc = raw[:, 0] / self.in_height * anc[:, 3] + anc[:, 1]
            xc = raw[:, 1] / self.in_width * anc[:, 2] + anc[:, 0]
            h = raw[:, 2] / self.in_height * anc[:, 3]
            w = raw[:, 3] / self.in_width * anc[:, 2]
            boxes = np.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], axis=1)
            return boxes, scores, np.zeros(n, np.int64)
        if fmt in ("mobilenet-ssd-postprocess", "tf-ssd"):
            if len(tensors) >= 4:  # reference 4-tensor postprocess output
                i_num, i_cls, i_score, i_loc = self.ssd_pp_indices
                boxes = host_array(tensors[i_loc]).reshape(-1, 4).astype(np.float32)
                scores = host_array(tensors[i_score]).astype(np.float32).reshape(-1)
                classes = host_array(tensors[i_cls]).astype(np.int64).reshape(-1)
                n = min(len(boxes), len(scores), len(classes))
                return boxes[:n], scores[:n], classes[:n]
            boxes = host_array(tensors[0]).reshape(-1, 4).astype(np.float32)
            scores = host_array(tensors[1]).astype(np.float32)
            if scores.ndim > 1:
                scores = scores.reshape(boxes.shape[0], -1)
                classes = scores.argmax(-1)
                scores = scores.max(-1)
            else:
                scores = scores.reshape(-1)
                classes = np.zeros(scores.shape[0], np.int64)
            return boxes, scores, classes
        if fmt in ("yolov5", "yolov8"):
            a = host_array(tensors[0]).astype(np.float32)
            a = a.reshape(-1, a.shape[-1]) if a.ndim > 2 else a
            if a.size == 0:  # zero candidates: legal on flexible streams
                empty = np.zeros((0,), np.float32)
                return np.zeros((0, 4), np.float32), empty, empty.astype(np.int64)
            if fmt == "yolov8":
                transpose = (
                    self.layout == "coords-first"
                    or (self.layout == "auto" and a.shape[0] < a.shape[1])
                )
                if transpose:  # (4+C, N) layout
                    a = a.T
                cxcywh, cls = a[:, :4], a[:, 4:]
                scores = cls.max(-1)
                classes = cls.argmax(-1)
            else:
                cxcywh, obj, cls = a[:, :4], a[:, 4], a[:, 5:]
                cls_score = cls.max(-1) if cls.size else np.ones_like(obj)
                scores = obj * cls_score
                classes = cls.argmax(-1) if cls.size else np.zeros(len(obj), np.int64)
            # normalize if values look like pixels
            scale = (
                np.array([self.width, self.height, self.width, self.height], np.float32)
                if cxcywh.max() > 2.0
                else np.ones(4, np.float32)
            )
            cx, cy = cxcywh[:, 0] / scale[0], cxcywh[:, 1] / scale[1]
            w, h = cxcywh[:, 2] / scale[2], cxcywh[:, 3] / scale[3]
            boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=1)
            return boxes, scores, classes
        if fmt in _custom_parsers:
            return _custom_parsers[fmt](tensors)
        raise ValueError(f"bounding_boxes: unknown format '{self.fmt}'")

    # -- classic (reference-byte-compatible) path ---------------------------
    def _decode_classic(self, tensors) -> Buffer:
        from . import bbox_classic as bc

        fmt = self.fmt
        i_w, i_h = self.in_width, self.in_height
        if fmt in ("mobilenet-ssd", "tflite-ssd"):
            dets = bc.parse_mobilenet_ssd(
                host_array(tensors[0]).reshape(-1, 4),
                host_array(tensors[1]),
                self.anchors.T, i_w, i_h, self.score_threshold,
                scales=self.ssd_scales)
            dets = bc.nms_classic(dets, self.iou_threshold)
        elif fmt in ("mobilenet-ssd-postprocess", "tf-ssd"):
            # tensor mapping: reference defaults num=0, classes=1,
            # scores=2, locations=3 (MOBILENET_SSD_PP_BBOX_IDX_*_DEFAULT),
            # remappable via option3 "%i:%i:%i:%i,%i"; no NMS
            i_num, i_cls, i_score, i_loc = self.ssd_pp_indices
            dets = bc.parse_ssd_pp(
                host_array(tensors[i_num]), host_array(tensors[i_cls]),
                host_array(tensors[i_score]), host_array(tensors[i_loc]),
                i_w, i_h, self.score_threshold)
        elif fmt in ("yolov5", "yolov8"):
            num_info = 5 if fmt == "yolov5" else 4
            a = host_array(tensors[0])
            a = a.reshape(-1, a.shape[-1]) if a.ndim > 2 else a
            if a.size == 0:  # zero candidates: legal on flexible streams
                dets = []
            else:
                if fmt == "yolov8" and (
                    self.layout == "coords-first"
                    or (self.layout == "auto" and a.shape[0] < a.shape[1])
                ):  # (4+C, N) head layout, same rule as the overlay path
                    a = a.T
                dets = bc.parse_yolo(a, i_w, i_h, num_info,
                                     self.score_threshold, self.yolo_scaled)
            dets = bc.nms_classic(dets, self.iou_threshold)
        elif fmt == "mp-palm-detection":
            if not hasattr(self, "_classic_anchors"):
                # same grid generator as the overlay path, but pinned to the
                # reference's hardcoded 192 input (feature_map=ceil(192/stride))
                self._classic_anchors = _palm_anchors(self._palm_param, 192)
            dets = bc.parse_palm(
                host_array(tensors[0]), host_array(tensors[1]),
                self._classic_anchors, i_w, i_h, self.score_threshold)
            dets = bc.nms_classic(dets, self.iou_threshold)
        elif fmt in ("ov-person-detection", "ov-face-detection"):
            dets = bc.parse_ov(host_array(tensors[0]), i_w, i_h,
                               self.score_threshold)
        else:
            raise ValueError(
                f"bounding_boxes: style=classic unsupported for '{fmt}'")
        if self._tracker is not None:
            self._tracker.update(dets)
        frame, cells = bc.draw_classic(
            dets, self.width, self.height, i_w, i_h,
            self.labels or None, track=self.track)
        out = Buffer([frame])
        if self.log_results:
            _log_detections(self.fmt, dets)
        out.meta["detections"] = [
            {"box": [d.x, d.y, d.width, d.height], "score": d.prob,
             "class": d.class_id, "tracking_id": d.tracking_id,
             "label": (self.labels[d.class_id]
                       if 0 <= d.class_id < len(self.labels) else str(d.class_id))}
            for d in dets
        ]
        out.meta["label_cells"] = cells
        return out

    # -- device-side reduction (overlay path) --------------------------------
    #
    # Candidate parsing + top-K selection run where the batch lies (on the
    # card for CUDA tensors); only (K, 4+2) rows per frame cross to the
    # host instead of the full detection head (SSD at 224: 3135×95 floats
    # → 256×6). NMS + drawing stay on host — greedy NMS on ≤K candidates
    # is microseconds. The ``classic`` byte-parity path never reduces
    # (host-exact by design).

    DEVICE_TOPK = 256  # default candidate cap (option10 overrides); every
    # score above threshold in a realistic scene fits — beyond it the
    # reference caps detections too

    def make_reduce(self, in_info: TensorsInfo):
        if self.style == "classic" or self.fmt in _custom_parsers:
            return None

        k_cap = self.device_topk
        thresh = self.score_threshold

        def reduce(ts):
            boxes, scores, classes = self._parse_torch(ts)
            # counted BEFORE the cap: decode_reduced compares it against
            # the kept count to detect a truncation that silently diverges
            # device results from a host decode of the identical stream
            n_above = (scores > thresh).sum(-1).to(torch.int32)
            if boxes.shape[1] > k_cap:
                scores, idx = top_k(scores, k_cap)
                boxes = torch.gather(
                    boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
                classes = torch.gather(classes, 1, idx)
            return (boxes.float(), scores.float(),
                    classes.to(torch.int32), n_above)
        return reduce

    def _parse_torch(self, ts):
        """Batched torch mirror of ``_parse``, run where the tensors lie:
        tensors (B, ...) → (boxes (B,N,4) [ymin,xmin,ymax,xmax], scores
        (B,N), classes (B,N)). Its arithmetic is nnstreamer_tpu's jitted
        reduce, op for op: a division by a constant is a multiply by the
        float32 reciprocal, as XLA compiles it."""
        fmt = self.fmt
        b = ts[0].shape[0]
        dev = ts[0].device
        if fmt in ("mobilenet-ssd", "tflite-ssd"):
            loc = ts[0].reshape(b, -1, 4).float()
            logits = ts[1].float().reshape(b, loc.shape[1], -1)
            anc = torch.as_tensor(self.anchors, device=dev)  # (N, 4) [cy, cx, h, w]
            vy, vx, vh, vw = (1.0 / s for s in self.ssd_scales)
            cy = loc[..., 0] * vy * anc[:, 2] + anc[:, 0]
            cx = loc[..., 1] * vx * anc[:, 3] + anc[:, 1]
            h = anc[:, 2] * torch.exp(loc[..., 2] * vh)
            w = anc[:, 3] * torch.exp(loc[..., 3] * vw)
            boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                                dim=-1)
            scores = torch.sigmoid(logits)
            return boxes, scores.amax(-1), scores.argmax(-1)
        if fmt in ("ov-person-detection", "ov-face-detection"):
            a = ts[0].float().reshape(b, -1, 7)
            # rows end at the first negative image_id: running-AND mask
            valid = (a[..., 0] >= 0).to(torch.int32).cumprod(dim=1).bool()
            boxes = a[..., [4, 3, 6, 5]]
            scores = torch.where(valid, a[..., 2],
                                 torch.full_like(a[..., 2], -1.0))  # below any threshold
            classes = torch.full(a.shape[:2], -1, dtype=torch.int32, device=dev)
            return boxes, scores, classes
        if fmt == "mp-palm-detection":
            anc = torch.as_tensor(self.palm_anchors, device=dev)  # (A,4) [xc, yc, w, h]
            raw = ts[0].float().reshape(b, -1, 18)
            sc = ts[1].float().reshape(b, -1)
            if raw.shape[1] != anc.shape[0] or sc.shape[1] != anc.shape[0]:
                raise ValueError(
                    f"mp-palm-detection: {raw.shape[1]} box rows / "
                    f"{sc.shape[1]} scores vs {anc.shape[0]} anchors — "
                    "check option5 (model input size) and option3 "
                    "(anchor params)")
            scores = torch.sigmoid(sc.clamp(-100.0, 100.0))
            ry, rx = _reciprocal(self.in_height), _reciprocal(self.in_width)
            yc = raw[..., 0] * ry * anc[:, 3] + anc[:, 1]
            xc = raw[..., 1] * rx * anc[:, 2] + anc[:, 0]
            h = raw[..., 2] * ry * anc[:, 3]
            w = raw[..., 3] * rx * anc[:, 2]
            boxes = torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2],
                                dim=-1)
            return boxes, scores, torch.zeros(scores.shape, dtype=torch.int32,
                                              device=dev)
        if fmt in ("mobilenet-ssd-postprocess", "tf-ssd"):
            if len(ts) >= 4:  # reference 4-tensor postprocess output
                i_num, i_cls, i_score, i_loc = self.ssd_pp_indices
                boxes = ts[i_loc].reshape(b, -1, 4).float()
                scores = ts[i_score].float().reshape(b, -1)
                classes = ts[i_cls].reshape(b, -1).to(torch.int32)
                n = min(boxes.shape[1], scores.shape[1], classes.shape[1])
                return boxes[:, :n], scores[:, :n], classes[:, :n]
            boxes = ts[0].reshape(b, -1, 4).float()
            scores = ts[1].float()
            if scores.ndim > 2 or scores.numel() != b * boxes.shape[1]:
                scores = scores.reshape(b, boxes.shape[1], -1)
                return boxes, scores.amax(-1), scores.argmax(-1)
            return (boxes, scores.reshape(b, -1),
                    torch.zeros((b, boxes.shape[1]), dtype=torch.int32,
                                device=dev))
        if fmt in ("yolov5", "yolov8"):
            a = ts[0].float()
            a = a.reshape(b, -1, a.shape[-1]) if a.ndim != 3 else a
            if fmt == "yolov8":
                if (self.layout == "coords-first"
                        or (self.layout == "auto" and a.shape[1] < a.shape[2])):
                    a = a.transpose(1, 2)  # (B, 4+C, N) layout
                cxcywh, cls = a[..., :4], a[..., 4:]
                scores, classes = cls.amax(-1), cls.argmax(-1)
            else:
                cxcywh, obj, cls = a[..., :4], a[..., 4], a[..., 5:]
                if cls.shape[-1]:
                    scores = obj * cls.amax(-1)
                    classes = cls.argmax(-1)
                else:
                    scores = obj
                    classes = torch.zeros(obj.shape, dtype=torch.int32, device=dev)
            # normalize if values look like pixels — PER FRAME, like the
            # host path's data-dependent branch
            pixels = cxcywh.amax(dim=(1, 2)) > 2.0  # (B,)
            whwh = torch.tensor([self.width, self.height, self.width,
                                 self.height], dtype=torch.float32, device=dev)
            scale = torch.where(pixels[:, None, None], whwh,
                                torch.ones(4, dtype=torch.float32, device=dev))
            cx, cy = cxcywh[..., 0] / scale[..., 0], cxcywh[..., 1] / scale[..., 1]
            w, h = cxcywh[..., 2] / scale[..., 2], cxcywh[..., 3] / scale[..., 3]
            boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                                dim=-1)
            return boxes, scores, classes
        raise ValueError(f"bounding_boxes: unknown format '{self.fmt}'")

    def decode_reduced(self, arrays, in_info: TensorsInfo) -> Optional[Buffer]:
        boxes, scores, classes, n_above = (np.asarray(a) for a in arrays)
        if not self._topk_warned and int(n_above) > boxes.shape[0]:
            self._topk_warned = True
            from ..utils.log import logger

            logger.warning(
                "bounding_boxes[%s]: device top-k cap %d truncated %d "
                "above-threshold candidates — results diverge from a host "
                "decode of this stream; raise option10 (device top-k) to "
                "keep them (further truncations are silent)",
                self.fmt, boxes.shape[0], int(n_above) - boxes.shape[0])
        return self._render_overlay(boxes, scores, classes.astype(np.int64))

    # -- decode -------------------------------------------------------------
    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        if self.style == "classic":
            return self._decode_classic(buf.tensors)
        boxes, scores, classes = self._parse(buf.tensors)
        return self._render_overlay(boxes, scores, classes)

    def _render_overlay(self, boxes, scores, classes) -> Optional[Buffer]:
        if self.use_nms:
            keep = nms_numpy(boxes, scores, self.iou_threshold, self.score_threshold)
        else:  # ov-*: the model already suppressed; threshold only
            keep = np.nonzero(scores >= self.score_threshold)[0]
        frame = np.zeros((self.height, self.width, 4), np.uint8)
        detections = []
        for i in keep:
            ymin, xmin, ymax, xmax = np.clip(boxes[i], 0.0, 1.0)
            x1, y1 = int(xmin * self.width), int(ymin * self.height)
            x2, y2 = int(xmax * self.width), int(ymax * self.height)
            cls = int(classes[i])
            color = _class_color(cls)
            _draw_rect(frame, x1, y1, x2, y2, color)
            detections.append({
                "box": [x1, y1, x2 - x1, y2 - y1],
                "score": float(scores[i]),
                "class": cls,
                "label": self.labels[cls] if 0 <= cls < len(self.labels) else str(cls),
            })
        out = Buffer([frame])
        if self.log_results:
            _log_detections(self.fmt, detections)
        out.meta["detections"] = detections
        return out



def _reciprocal(x) -> float:
    """1/x rounded to float32, what XLA multiplies by for ``/ x``."""
    return float(np.float32(1.0) / np.float32(x))


def _palm_scale(min_scale: float, max_scale: float, idx: int, n: int) -> float:
    if n == 1:
        return (min_scale + max_scale) * 0.5
    return min_scale + (max_scale - min_scale) * idx / (n - 1.0)


def _palm_anchors(params: Optional[str], input_size: int = 192) -> np.ndarray:
    """SSD anchor grid for the mediapipe palm model.

    Layers sharing a stride are folded into one grid with 2 anchors per
    same-stride layer per cell; defaults (4 layers, strides 8:16:16:16,
    scales 1.0, 192×192 input) yield 2016 anchors — reference
    ``_mp_palm_detection_generate_anchors`` (tensordec-boundingbox.c:673;
    the reference hardcodes 192, here the grid follows the option8 input
    size so non-192 palm variants decode against a matching grid).
    Returns (A, 4) float32 [x_center, y_center, w, h], normalized.
    """
    num_layers, min_scale, max_scale = 4, 1.0, 1.0
    offset_x, offset_y = 0.5, 0.5
    strides = [8, 16, 16, 16]
    if params:
        parts = [p for p in str(params).split(":")]
        vals = [float(p) if p else None for p in parts]
        if len(vals) > 0 and vals[0] is not None:
            num_layers = int(vals[0])
        if len(vals) > 1 and vals[1] is not None:
            min_scale = vals[1]
        if len(vals) > 2 and vals[2] is not None:
            max_scale = vals[2]
        if len(vals) > 3 and vals[3] is not None:
            offset_x = vals[3]
        if len(vals) > 4 and vals[4] is not None:
            offset_y = vals[4]
        given = [int(v) for v in vals[5:] if v is not None]
        if given:
            strides = given
    strides = (strides + [strides[-1]] * num_layers)[:num_layers]
    out = []
    layer = 0
    while layer < num_layers:
        sizes = []  # (w, h) per anchor at each cell
        last = layer
        while last < num_layers and strides[last] == strides[layer]:
            for idx in (last, last + 1):
                s = _palm_scale(min_scale, max_scale, idx, num_layers)
                sizes.append((s, s))  # aspect ratio 1.0 twice per layer
            last += 1
        fm = int(np.ceil(input_size / strides[layer]))
        for y in range(fm):
            for x in range(fm):
                for w, h in sizes:
                    out.append(((x + offset_x) / fm, (y + offset_y) / fm, w, h))
        layer = last
    return np.asarray(out, np.float32)


def _class_color(cls: int) -> np.ndarray:
    rng = np.random.default_rng(cls + 1)
    rgb = rng.integers(64, 255, 3)
    return np.array([*rgb, 255], np.uint8)


def _draw_rect(frame: np.ndarray, x1: int, y1: int, x2: int, y2: int,
               color: np.ndarray, thickness: int = 2) -> None:
    h, w = frame.shape[:2]
    x1, x2 = max(x1, 0), min(x2, w - 1)
    y1, y2 = max(y1, 0), min(y2, h - 1)
    if x2 <= x1 or y2 <= y1:
        return
    t = thickness
    frame[y1:y1 + t, x1:x2] = color
    frame[max(y2 - t, 0):y2, x1:x2] = color
    frame[y1:y2, x1:x1 + t] = color
    frame[y1:y2, max(x2 - t, 0):x2] = color
