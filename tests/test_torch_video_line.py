"""The raw-media line end to end on the CPU, the port against
nnstreamer_tpu on the same weights:

    videotestsrc pattern=gradient ! videoconvert ! videoscale
      ! video/x-raw,width=32,height=32,format=RGB
      ! tensor_converter frames-per-tensor=4
      ! tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5
      ! queue ! tensor_filter (MobileNet-v2, float) ! tee
      ! tensor_decoder mode=image_labeling frames-in=4 ! tensor_sink

at 32x32 frames and a narrow MobileNet-v2 (width 0.25, 10 classes) whose
parameters are nnstreamer_tpu's, carried by
models/convert.py::mobilenet_params_from_flax. The port runs with
``accelerator=cpu`` on the transform and the filter. Logits within 1e-5
absolute (float32 on both sides, another summation order), the
transform's output within rtol 1e-6, labels and caps exact. Without
``accelerator=cpu`` the port's line posts a bus ERROR naming the missing
card."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models.mobilenet_v2 import build_mobilenet_v2 as jbuild
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.models import mobilenet_v2 as tmb
from nnstreamer_tpu_torch.runtime.parse import parse_launch

LOGIT_ATOL = 1e-5
CLASSES, WIDTH, SIZE, FPT, BATCHES = 10, 0.25, 32, 4, 3
MODULE = __name__
# set by the ``entries`` fixture; named by the launch lines as MODULE:attr
JAX_ENTRY = None
PORT_ENTRY = None


class _JaxEntry:
    def __init__(self, apply_fn, params):
        self.apply_fn, self.params = apply_fn, params

    def make(self):
        return lambda x: self.apply_fn(self.params, x)


@pytest.fixture(scope="module")
def entries():
    apply_fn, params = jbuild(num_classes=CLASSES, width_mult=WIDTH,
                              compute_dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = dataclasses.replace(tmb.filter_model, num_classes=CLASSES,
                               width_mult=WIDTH, compute_dtype="float32",
                               params=tree)
    mod = sys.modules[MODULE]
    mod.JAX_ENTRY, mod.PORT_ENTRY = _JaxEntry(apply_fn, params), port
    return mod.JAX_ENTRY, port


@pytest.fixture
def labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"class{i}\n" for i in range(CLASSES)))
    return path


def _line(filter_props: str, transform_props: str, labels) -> str:
    return (
        f"videotestsrc num-buffers={FPT * BATCHES} pattern=gradient ! "
        "videoconvert ! videoscale ! "
        f"video/x-raw,width={SIZE},height={SIZE},format=RGB ! "
        f"tensor_converter frames-per-tensor={FPT} ! tensor_transform "
        "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 "
        f"{transform_props} name=tr ! queue max-size-buffers=4 ! "
        f"tensor_filter {filter_props} name=f ! tee name=t "
        f"t. ! queue ! tensor_decoder mode=image_labeling option1={labels} "
        f"frames-in={FPT} ! tensor_sink name=out max-stored=0 "
        "t. ! queue ! tensor_sink name=logits max-stored=0")


JAX_PROPS = f"framework=jax model={MODULE}:JAX_ENTRY"
PORT_PROPS = f"framework=torch model={MODULE}:PORT_ENTRY"


def _run(parse, line):
    pipe = parse(line)
    labels, logits, frames = [], [], []
    pipe.get("out").connect(labels.append)
    pipe.get("logits").connect(logits.append)
    tr = pipe.get("tr")
    transform = tr.transform

    def tapped(buf):
        out = transform(buf)
        frames.append(out.tensors[0])
        return out

    tr.transform = tapped
    pipe.play()
    try:
        msg = pipe.wait(timeout=120)
        caps = {n: pipe.get(n).sinkpad.caps for n in ("out", "logits")}
    finally:
        pipe.stop()
    return msg, caps, labels, logits, frames


def test_video_line_matches_jax(entries, labels):
    wmsg, wcaps, wlab, wlog, wframes = _run(
        jax_parse_launch, _line(JAX_PROPS, "", labels))
    gmsg, gcaps, glab, glog, gframes = _run(
        parse_launch, _line(PORT_PROPS + " accelerator=cpu",
                            "accelerator=cpu", labels))
    assert wmsg.type.value == gmsg.type.value == "eos", (wmsg, gmsg)
    assert {k: str(v) for k, v in gcaps.items()} == \
        {k: str(v) for k, v in wcaps.items()}
    assert str(gcaps["logits"]) == ("other/tensors,format=static,"
                                    f"num_tensors=1,dimensions={CLASSES}:"
                                    f"{FPT},types=float32")
    # the transform: float32 frames in [-1, 1] on the CPU
    assert len(gframes) == len(wframes) == BATCHES
    for g, w in zip(gframes, wframes):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.dtype is torch.float32 and tuple(g.shape) == (FPT, SIZE,
                                                               SIZE, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # the filter's logits
    assert len(glog) == len(wlog) == BATCHES
    for g, w in zip(glog, wlog):
        t = g.tensors[0]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), np.asarray(w.tensors[0]),
                                   rtol=0, atol=LOGIT_ATOL)
    # one label buffer per frame, equal to nnstreamer_tpu's, the argmax of
    # the logits
    assert len(glab) == len(wlab) == FPT * BATCHES
    want_idx = torch.cat([g.tensors[0].argmax(-1) for g in glog]).tolist()
    assert [g.meta["label_index"] for g in glab] == want_idx
    for g, w in zip(glab, wlab):
        assert g.meta["labels"] == w.meta["labels"]
        assert g.meta["label_indices"] == w.meta["label_indices"]
        assert bytes(g.tensors[0]) == bytes(np.asarray(w.tensors[0]))


def test_video_line_frames_are_the_gradient(entries, labels):
    """The converter's batches are the gradient frames, stacked in order."""
    _, _, _, _, frames = _run(parse_launch, _line(
        PORT_PROPS + " accelerator=cpu", "accelerator=cpu", labels))
    xx = np.linspace(0, 255, SIZE, dtype=np.uint8)
    for b, batch in enumerate(frames):
        for i in range(FPT):
            want = np.broadcast_to(xx[None, :, None], (SIZE, SIZE, 3)).copy()
            want[:, :, 0] = (want[:, :, 0].astype(np.int32) + b * FPT + i) % 256
            np.testing.assert_allclose(
                batch[i].numpy(),
                (want.astype(np.float32) - 127.5) * np.float32(1 / 127.5),
                rtol=0, atol=0)


@pytest.mark.parametrize("filter_cpu,transform_cpu", [(False, False),
                                                      (True, False),
                                                      (False, True)])
def test_without_the_cpu_asked_the_line_posts_a_card_error(
        entries, labels, filter_cpu, transform_cpu):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    line = _line(PORT_PROPS + (" accelerator=cpu" if filter_cpu else ""),
                 "accelerator=cpu" if transform_cpu else "", labels)
    msg, _, lab, log, _ = _run(parse_launch, line)
    assert msg.type is MessageType.ERROR and not lab and not log
    assert "no CUDA device" in str(msg.data)
    assert "cpu" in str(msg.data)
