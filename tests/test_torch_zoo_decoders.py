"""The port's bounding_boxes, pose_estimation, image_segment, tensor_region
and font decoders (decoders/{bounding_boxes,bbox_classic,segment_pose,
simple,font}.py) against nnstreamer_tpu's: the golden bytes of
tests/golden/ through the port's tensor_decoder; the torch reduce on a
batch of CPU tensors against nnstreamer_tpu's jitted jnp reduce on the
same batch (the cases of tests/test_decoder_device_reduce.py, and more);
planted ties for the top-k cap and the argmaxes; the host path on CPU
bfloat16 tensors.

All comparisons are exact — decoded bytes, boxes, classes, keypoints and
class maps — except the scores that a sigmoid computes on the reduce path
(pose heatmap-offset, palm): XLA's sigmoid and torch's differ by an ulp,
so those scores are held within 2 float32 ulps of 1 (2.4e-7)."""
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, DataType, TensorSpec, TensorsInfo
from nnstreamer_tpu_torch.decoders.base import top_k
from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, get, names
from nnstreamer_tpu_torch.runtime.parse import parse_launch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
sys.path.insert(0, GOLDEN)

from generate import cases  # noqa: E402

ZOO_MODES = ("bounding_boxes", "pose_estimation", "image_segment",
             "tensor_region", "font")
GOLDEN_CASES = [c for c in cases() if c[1] in ZOO_MODES]
SIGMOID_ATOL = 2.4e-7

_TYPES = {np.dtype(np.float32): "float32", np.dtype(np.uint8): "uint8",
          np.dtype(np.int32): "int32"}


def _dims(shape) -> str:
    return ":".join(str(d) for d in reversed(shape))


def _caps(arrays) -> str:
    return (f"other/tensors,format=static,num_tensors={len(arrays)},"
            f"dimensions={'.'.join(_dims(a.shape) for a in arrays)},"
            f"types={','.join(_TYPES[np.asarray(a).dtype] for a in arrays)}")


def _run(pkg, caps, dec, bufs):
    """appsrc ! tensor_decoder <dec> ! tensor_sink in either package."""
    parse = parse_launch if pkg == "port" else jax_parse_launch
    pipe = parse(f"appsrc name=in caps={caps} ! tensor_decoder {dec} "
                 "! tensor_sink name=out max-stored=0")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        for b in bufs:
            pipe.get("in").push_buffer(b)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type.value == "eos", (pkg, msg)
    return got


def _buf(pkg, where, arrays):
    """One buffer of ``arrays``: numpy on the host, or a batch where it
    lies (CPU torch tensors in the port, JAX arrays in nnstreamer_tpu)."""
    if where == "host":
        ts = [np.asarray(a) for a in arrays]
    elif pkg == "port":
        ts = [torch.from_numpy(np.array(a)) for a in arrays]
    else:
        ts = [jnp.asarray(a) for a in arrays]
    return (Buffer if pkg == "port" else JBuffer)(ts)


def _meta(buf):
    """What a decoded buffer says, floats held apart: (bytes, exact meta,
    scores)."""
    meta, scores = {}, []
    for key in ("detections", "keypoints"):
        if key in buf.meta:
            meta[key] = [{k: v for k, v in d.items() if k != "score"}
                         for d in buf.meta[key]]
            scores += [d["score"] for d in buf.meta[key]]
    if "class_map" in buf.meta:
        cm = np.asarray(buf.meta["class_map"])
        meta["class_map"] = (cm.dtype.kind, cm.tolist())
    return (bytes(np.ascontiguousarray(np.asarray(buf.tensors[0]))), meta,
            scores)


def _same(got, want, score_atol=0.0):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        gb, gm, gs = _meta(g)
        wb, wm, ws = _meta(w)
        assert gb == wb
        assert gm == wm
        np.testing.assert_allclose(gs, ws, rtol=0, atol=score_atol)


def _reduce_vs_jax(dec, arrays, fi, score_atol=0.0):
    """The port's reduce over one batch of CPU tensors equals
    nnstreamer_tpu's jitted reduce over the same batch as JAX arrays, and
    the port's own host path on the same frames."""
    caps = _caps(arrays)
    line = f"{dec} frames-in={fi}"
    got = _run("port", caps, line, [_buf("port", "device", arrays)])
    want = _run("jax", caps, line, [_buf("jax", "device", arrays)])
    assert len(got) == fi
    _same(got, want, score_atol)
    host = _run("port", caps, line, [_buf("port", "host", arrays)])
    _same(got, host, score_atol)
    return got


def test_registry_has_the_zoo_modes():
    assert set(ZOO_MODES) <= set(names(SubpluginKind.DECODER))
    for mode in ZOO_MODES:
        assert get(SubpluginKind.DECODER, mode).MODE == mode


@pytest.mark.parametrize("name,mode,options,arrays", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_bytes_through_the_element(name, mode, options, arrays):
    opts = " ".join(f"option{i + 1}={o}" for i, o in enumerate(options)
                    if o is not None)
    got = _run("port", _caps(arrays), f"mode={mode} {opts}",
               [_buf("port", "host", arrays)])
    assert len(got) == 1
    blob = b"".join(np.ascontiguousarray(np.asarray(t)).tobytes()
                    for t in got[0].tensors)
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as fh:
        assert blob == fh.read()


@pytest.mark.parametrize("name,mode,options,arrays", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_reduce_path_equals_host(name, mode, options, arrays):
    """The same golden frame as a batch of one CPU tensor: the reduce path
    (where the decoder has one) gives the golden bytes too."""
    opts = " ".join(f"option{i + 1}={o}" for i, o in enumerate(options)
                    if o is not None)
    batch = [np.asarray(a)[None] for a in arrays]
    got = _run("port", _caps(batch), f"mode={mode} {opts} frames-in=1",
               [_buf("port", "device", batch)])
    blob = b"".join(np.ascontiguousarray(np.asarray(t)).tobytes()
                    for t in got[0].tensors)
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as fh:
        assert blob == fh.read()


# ---------------------------------------------------------------------------
# the reduce cases of tests/test_decoder_device_reduce.py, port vs JAX

def test_segment_reduce():
    logits = np.random.default_rng(0).standard_normal((4, 8, 6, 5)).astype(np.float32)
    got = _reduce_vs_jax("mode=image_segment option1=tflite-deeplab",
                         [logits], 4)
    assert np.asarray(got[0].meta["class_map"]).tolist() == \
        logits[0].argmax(-1).tolist()


def test_snpe_depth_reduce():
    depth = np.random.default_rng(1).standard_normal((3, 8, 6)).astype(np.float32) * 7
    caps = _caps([depth])
    dec = "mode=image_segment option1=snpe-depth frames-in=3"
    got = _run("port", caps, dec, [_buf("port", "device", [depth])])
    want = _run("jax", caps, dec, [_buf("jax", "device", [depth])])
    _same(got, want)
    # host min/max normalization of each (8, 6) frame against the reduce:
    # within one step, as nnstreamer_tpu's own test holds its paths
    host = _run("port", _caps([depth[0]]), "mode=image_segment "
                "option1=snpe-depth", [_buf("port", "host", [d]) for d in depth])
    for a, b in zip(got, host):
        d = np.abs(np.asarray(a.tensors[0]).astype(np.int16)
                   - np.asarray(b.tensors[0]).astype(np.int16))
        assert d.max() <= 1


def test_pose_heatmap_reduce():
    heat = np.random.default_rng(2).standard_normal((4, 6, 6, 14)).astype(np.float32)
    _reduce_vs_jax("mode=pose_estimation option1=48:48 option2=heatmap",
                   [heat], 4)


def test_pose_heatmap_offset_reduce():
    rng = np.random.default_rng(3)
    heat = rng.standard_normal((3, 5, 5, 17)).astype(np.float32)
    off = rng.standard_normal((3, 5, 5, 34)).astype(np.float32) * 3
    _reduce_vs_jax("mode=pose_estimation option1=64:64 option2=32:32 "
                   "option4=heatmap-offset", [heat, off], 3,
                   score_atol=SIGMOID_ATOL)


def test_pose_coords_reduce():
    coords = np.random.default_rng(4).random((2, 17, 3)).astype(np.float32)
    _reduce_vs_jax("mode=pose_estimation option1=32:32 option4=coords",
                   [coords], 2)


def _boxes_scores(rng, n=12, c=6, b=4):
    raw = np.sort(rng.random((b, n, 4)).astype(np.float32), axis=-1)
    boxes = np.stack([raw[..., 0] * 0.5, raw[..., 1] * 0.5,
                      0.5 + raw[..., 2] * 0.5, 0.5 + raw[..., 3] * 0.5],
                     axis=-1)
    return boxes, rng.random((b, n, c)).astype(np.float32)


def test_bbox_ssd_postprocess_reduce():
    boxes, scores = _boxes_scores(np.random.default_rng(6))
    got = _reduce_vs_jax("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
                         "option4=64:64", [boxes, scores], 4)
    assert any(g.meta["detections"] for g in got)


def test_bbox_ssd_postprocess_1d_scores_reduce():
    boxes, scores = _boxes_scores(np.random.default_rng(16), c=1)
    _reduce_vs_jax("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
                   "option4=64:64", [boxes, scores[..., 0]], 4)


def test_bbox_ssd_pp_four_tensors_reduce():
    rng = np.random.default_rng(17)
    boxes, scores = _boxes_scores(rng, n=10, c=1, b=2)
    classes = rng.integers(0, 5, (2, 10)).astype(np.float32)
    num = np.full((2, 1), 10, np.float32)
    _reduce_vs_jax("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
                   "option4=64:64", [num, classes, scores[..., 0], boxes], 2)


def test_bbox_yolov5_reduce():
    a = np.random.default_rng(7).random((2, 20, 8)).astype(np.float32)
    _reduce_vs_jax("mode=bounding_boxes option1=yolov5 option4=64:64 "
                   "option5=64:64", [a], 2)


def test_bbox_yolov8_pixels_reduce():
    """Pixel coordinates (max > 2) are normalized per frame; (4+C, N)."""
    rng = np.random.default_rng(18)
    a = rng.random((2, 7, 30)).astype(np.float32)
    a[0, :4] *= 60.0
    _reduce_vs_jax("mode=bounding_boxes option1=yolov8 option3=0:0.3:0.5 "
                   "option4=64:48", [a], 2)


def test_bbox_ov_person_reduce():
    rng = np.random.default_rng(19)
    a = rng.random((2, 9, 7)).astype(np.float32)
    a[..., 2] = rng.uniform(0.7, 1.0, (2, 9))
    a[0, 5, 0] = -1          # rows end at the first negative image_id
    _reduce_vs_jax("mode=bounding_boxes option1=ov-person-detection "
                   "option4=64:64", [a], 2)


def test_bbox_palm_reduce():
    """mp-palm-detection at its default 192 input (2016 anchors): the
    reduce's divisions by the input size are XLA's reciprocal multiplies."""
    rng = np.random.default_rng(20)
    raw = rng.standard_normal((2, 2016, 18)).astype(np.float32) * 20
    sc = rng.standard_normal((2, 2016)).astype(np.float32) * 3
    _reduce_vs_jax("mode=bounding_boxes option1=mp-palm-detection "
                   "option3=0.9 option4=64:64 option10=4096", [raw, sc], 2,
                   score_atol=SIGMOID_ATOL)


def test_bbox_topk_cap_engages(caplog):
    from nnstreamer_tpu_torch.decoders.bounding_boxes import BoundingBoxes

    n = BoundingBoxes.DEVICE_TOPK + 40
    boxes, scores = _boxes_scores(np.random.default_rng(8), n=n, c=2, b=2)
    dec = ("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
           "option4=32:32")
    with caplog.at_level("WARNING", logger="nnstreamer_tpu_torch"):
        got = _reduce_vs_jax_capped(dec, [boxes, scores], 2)
    assert got[0].meta["detections"]
    warned = [r for r in caplog.records if r.name == "nnstreamer_tpu_torch"
              and "device top-k cap 256" in r.message]
    assert len(warned) == 1


def _reduce_vs_jax_capped(dec, arrays, fi):
    """As _reduce_vs_jax, without the host comparison: a capped reduce
    keeps fewer candidates than the host path sees."""
    caps = _caps(arrays)
    line = f"{dec} frames-in={fi}"
    got = _run("port", caps, line, [_buf("port", "device", arrays)])
    want = _run("jax", caps, line, [_buf("jax", "device", arrays)])
    _same(got, want)
    return got


def test_tensor_region_simplified_reduce():
    rng = np.random.default_rng(22)
    boxes = np.sort(rng.random((3, 10, 4)).astype(np.float32), axis=-1)
    scores = rng.random((3, 10)).astype(np.float32)
    _reduce_vs_jax("mode=tensor_region option1=2 option2=64:48",
                   [boxes, scores.reshape(-1)], 3)


def test_tensor_region_without_scores_reduce():
    boxes = np.random.default_rng(23).random((2, 6, 4)).astype(np.float32)
    _reduce_vs_jax("mode=tensor_region option1=3 option2=10:10", [boxes], 2)


def test_segment_fi1_uses_the_reduce(monkeypatch):
    """frames-in=1 with a tensor batch: image-shaped modes still reduce
    where the batch lies; host decode() is never called."""
    from nnstreamer_tpu_torch.decoders.segment_pose import ImageSegment

    def no_host(self, buf, info):
        raise AssertionError("host decode() on a tensor batch")

    monkeypatch.setattr(ImageSegment, "decode", no_host)
    logits = np.random.default_rng(13).standard_normal((1, 8, 6, 5)).astype(np.float32)
    got = _run("port", _caps([logits]),
               "mode=image_segment option1=tflite-deeplab",
               [_buf("port", "device", [logits])])
    want = _run("jax", _caps([logits]),
                "mode=image_segment option1=tflite-deeplab",
                [_buf("jax", "device", [logits])])
    assert len(got) == 1 and got[0].tensors[0].shape == (8, 6, 3)
    _same(got, want)


def test_bbox_fi1_uses_the_reduce(monkeypatch):
    from nnstreamer_tpu_torch.decoders.bounding_boxes import BoundingBoxes

    def no_host(self, buf, info):
        raise AssertionError("host decode() on a tensor batch")

    monkeypatch.setattr(BoundingBoxes, "decode", no_host)
    boxes, scores = _boxes_scores(np.random.default_rng(14), b=1)
    dec = "mode=bounding_boxes option1=mobilenet-ssd-postprocess option4=64:64"
    got = _run("port", _caps([boxes, scores]), dec,
               [_buf("port", "device", [boxes, scores])])
    want = _run("jax", _caps([boxes, scores]), dec,
                [_buf("jax", "device", [boxes, scores])])
    _same(got, want)


def test_classic_style_never_reduces():
    from nnstreamer_tpu_torch.decoders.bounding_boxes import BoundingBoxes

    dec = BoundingBoxes()
    dec.init(["yolov5", None, None, None, None, None, None, "classic"]
             + [None] * 4)
    assert dec.make_reduce(TensorsInfo.of(
        TensorSpec((1, 20, 8), DataType.FLOAT32))) is None


# ---------------------------------------------------------------------------
# planted ties

def test_top_k_keeps_index_order_among_ties():
    rng = np.random.default_rng(30)
    s = (rng.integers(0, 6, (3, 200)) / 8).astype(np.float32)
    vals, idx = top_k(torch.from_numpy(s), 50)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_bbox_topk_cap_with_ties():
    """Scores quantized to eighths: many ties at the cap's edge; the kept
    candidates are nnstreamer_tpu's (lax.top_k keeps the lower index)."""
    rng = np.random.default_rng(31)
    boxes, scores = _boxes_scores(rng, n=120, c=3, b=2)
    scores = (np.floor(scores * 8) / 8).astype(np.float32)
    _reduce_vs_jax_capped("mode=bounding_boxes option1=mobilenet-ssd-"
                          "postprocess option4=64:64 option10=16",
                          [boxes, scores], 2)


def test_bbox_class_argmax_ties():
    """Equal class scores: the first class wins, on both packages and on
    the host path."""
    rng = np.random.default_rng(32)
    boxes, scores = _boxes_scores(rng, n=12, c=4, b=2)
    scores[..., 2] = scores[..., 0] = scores.max(-1)
    _reduce_vs_jax("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
                   "option4=64:64", [boxes, scores], 2)


def test_segment_argmax_ties():
    rng = np.random.default_rng(33)
    logits = rng.integers(0, 3, (2, 8, 6, 5)).astype(np.float32)
    got = _reduce_vs_jax("mode=image_segment option1=tflite-deeplab",
                         [logits], 2)
    want = logits.argmax(-1)          # numpy: the first maximum
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.meta["class_map"]), w)


def test_pose_argmax_ties():
    """Tied heatmap maxima: the first in (gy, gx) scan order wins."""
    rng = np.random.default_rng(34)
    heat = rng.integers(0, 3, (2, 6, 6, 14)).astype(np.float32)
    _reduce_vs_jax("mode=pose_estimation option1=48:48 option2=heatmap",
                   [heat], 2)


# ---------------------------------------------------------------------------
# host paths nnstreamer_tpu's reduce tests do not cover

def test_tensor_region_priors_mode_matches(tmp_path):
    from nnstreamer_tpu_torch.models.ssd_mobilenet import save_anchors

    priors = tmp_path / "anchors.npy"
    save_anchors(str(priors), 64)
    rng = np.random.default_rng(40)
    loc = rng.standard_normal((255, 4)).astype(np.float32)
    logits = rng.standard_normal((255, 91)).astype(np.float32) * 2
    dec = f"mode=tensor_region option1=4 option3={priors} option4=64:64"
    got = _run("port", _caps([loc, logits]), dec,
               [_buf("port", "host", [loc, logits])])
    want = _run("jax", _caps([loc, logits]), dec,
                [_buf("jax", "host", [loc, logits])])
    assert np.asarray(got[0].tensors[0]).dtype == np.uint32
    _same(got, want)


def test_bbox_raw_ssd_host_matches(tmp_path):
    """option1=mobilenet-ssd (raw heads and a priors file), overlay and
    classic styles, on the host."""
    from nnstreamer_tpu_torch.models.ssd_mobilenet import save_anchors

    priors = tmp_path / "anchors.npy"
    save_anchors(str(priors), 64)
    rng = np.random.default_rng(41)
    loc = rng.standard_normal((255, 4)).astype(np.float32)
    logits = rng.standard_normal((255, 91)).astype(np.float32) * 2
    for style in ("overlay", "classic"):
        dec = (f"mode=bounding_boxes option1=mobilenet-ssd "
               f"option3={priors}:0.6 option4=64:64 option5=64:64 "
               f"option8={style}")
        got = _run("port", _caps([loc, logits]), dec,
                   [_buf("port", "host", [loc, logits])])
        want = _run("jax", _caps([loc, logits]), dec,
                    [_buf("jax", "host", [loc, logits])])
        _same(got, want, score_atol=0.0)
        assert got[0].meta["detections"], style


def test_bbox_classic_tracking_matches(tmp_path):
    """yolov5 in the classic style with centroid tracking over frames and
    a label file."""
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"obj{i}\n" for i in range(3)))
    rng = np.random.default_rng(42)
    frames = [rng.random((20, 8)).astype(np.float32) for _ in range(3)]
    dec = (f"mode=bounding_boxes option1=yolov5 option2={labels} "
           "option3=0:0.4:0.45 option4=80:60 option5=64:64 option6=1 "
           "option8=classic")
    got = _run("port", _caps(frames[:1]), dec,
               [_buf("port", "host", [f]) for f in frames])
    want = _run("jax", _caps(frames[:1]), dec,
                [_buf("jax", "host", [f]) for f in frames])
    _same(got, want)
    assert [g.meta["label_cells"] for g in got] == \
        [w.meta["label_cells"] for w in want]
    assert any(d["tracking_id"] > 0 for g in got for d in g.meta["detections"])


def test_font_options_match():
    text = np.frombuffer(b"Hello, NNS!\nline 2 ~", np.uint8)
    dec = "mode=font option1=48:40 option2=1 option3=10:200:30"
    got = _run("port", _caps([text]), dec, [_buf("port", "host", [text])])
    want = _run("jax", _caps([text]), dec, [_buf("jax", "host", [text])])
    _same(got, want)
    assert got[0].meta["text"] == want[0].meta["text"]


def test_pose_label_file_and_in_size(tmp_path):
    labels = tmp_path / "kp.txt"
    labels.write_text("".join(f"k{i}\n" for i in range(14)))
    heat = np.random.default_rng(43).standard_normal((1, 7, 9, 14)).astype(np.float32)
    dec = f"mode=pose_estimation option1=90:70 option2=45:35 option3={labels}"
    got = _run("port", _caps([heat]), dec, [_buf("port", "host", [heat])])
    want = _run("jax", _caps([heat]), dec, [_buf("jax", "host", [heat])])
    _same(got, want)
    assert [k["label"] for k in got[0].meta["keypoints"]] == \
        [k["label"] for k in want[0].meta["keypoints"]]


@pytest.mark.parametrize("dec", [
    "mode=image_segment option1=bogus",
    "mode=pose_estimation option4=bogus",
    "mode=bounding_boxes option1=mobilenet-ssd",
    "mode=bounding_boxes option10=0"])
def test_bad_options_fail_at_construction(dec):
    from nnstreamer_tpu_torch.runtime.element import ElementError

    with pytest.raises((ValueError, ElementError)):
        parse_launch(f"appsrc ! tensor_decoder {dec} ! tensor_sink")
    with pytest.raises(Exception):
        jax_parse_launch(f"appsrc ! tensor_decoder {dec} ! tensor_sink")


# ---------------------------------------------------------------------------
# host bfloat16: a CPU torch.bfloat16 tensor, never seen by numpy

BF16_CASES = [
    ("mode=image_segment option1=tflite-deeplab", [(1, 8, 6, 5)]),
    ("mode=pose_estimation option1=48:48 option2=heatmap", [(1, 6, 6, 14)]),
    ("mode=bounding_boxes option1=mobilenet-ssd-postprocess option4=64:64",
     [(1, 12, 4), (1, 12, 6)]),
    ("mode=tensor_region option1=2 option2=64:48", [(1, 10, 4), (10,)]),
]


@pytest.mark.parametrize("dec,shapes", BF16_CASES,
                         ids=[c[0].split()[0][5:] for c in BF16_CASES])
def test_host_bfloat16(dec, shapes):
    """The host path decodes a CPU bfloat16 buffer as nnstreamer_tpu
    decodes the same values as an ml_dtypes bfloat16 array."""
    rng = np.random.default_rng(50)
    arrays = [rng.random(s).astype(np.float32) for s in shapes]
    port = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    ref = [a.astype(ml_dtypes.bfloat16) for a in arrays]
    caps = _caps(arrays).replace("float32", "bfloat16")
    got = _run("port", caps, dec, [Buffer(port)])
    want = _run("jax", caps, dec, [JBuffer(ref)])
    _same(got, want)


def test_decoder_element_constructs_every_zoo_mode():
    for dec in ("mode=bounding_boxes option1=mobilenet-ssd-postprocess "
                "option3=,30 option4=224:224 frames-in=64",
                "mode=pose_estimation option1=224:224 option2=heatmap "
                "frames-in=64",
                "mode=image_segment option1=tflite-deeplab frames-in=64",
                "mode=tensor_region option1=4", "mode=font option1=64:32"):
        pipe = parse_launch(f"appsrc ! tensor_decoder {dec} name=d "
                            "! tensor_sink")
        assert pipe.get("d").decoder.MODE == dec.split()[0][5:]
