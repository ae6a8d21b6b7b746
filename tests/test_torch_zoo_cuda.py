"""The zoo slice on the card (marker ``cuda``; skips without a card). This
file needs neither JAX nor nnstreamer_tpu, so it runs where they are not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_zoo_cuda.py

The CPU builds are held against nnstreamer_tpu in test_torch_zoo.py and
test_torch_zoo_decoders.py; here the card is held against the CPU on the
same seeded weights and the same batches: the three models in float32
within the CPU tolerance (1e-5, and 1% of the centred output's std) with
cuDNN's TF32 switched on process-wide, bf16 within 5e-4 of float32 (SSD's
scores 2e-3, chip_smoke.py says why); the decoders' reduces, the stable
top-k, the first-maximum argmaxes and nms_torch on the card equal to the
CPU's exactly."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import Buffer, MessageType
from nnstreamer_tpu_torch.decoders.base import top_k
from nnstreamer_tpu_torch.models import deeplab, posenet, ssd_mobilenet
from nnstreamer_tpu_torch.models._blocks import make_u8_entry
from nnstreamer_tpu_torch.ops.nms import nms_torch
from nnstreamer_tpu_torch.runtime.parse import parse_launch

ATOL, CENTRED_SHARE, BF16_ATOL = 1e-5, 0.01, 5e-4
BF16_ATOL_SSD_SCORES = 2e-3
MODELS = {"ssd": ssd_mobilenet, "posenet": posenet, "deeplab": deeplab}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _frames(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 127, (n, 224, 224, 3))
                            .astype(np.uint8))


def _tuple(out):
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _centred(a):
    return a - a.mean(0, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_card_matches_cpu(cuda_card, name):
    mod = MODELS[name]
    f32 = make_u8_entry(replace(mod.filter_model, compute_dtype="float32"))
    x = _frames()
    want = _tuple(f32.make("cpu")(x))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = _tuple(f32.make(cuda_card)(x.to(cuda_card)))
        assert torch.backends.cudnn.allow_tf32      # restored after the call
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    bf = _tuple(mod.filter_model_u8.make(cuda_card)(x.to(cuda_card)))
    for i, (g, b, w) in enumerate(zip(got, bf, want)):
        assert g.is_cuda and g.dtype is torch.float32 and g.shape == w.shape
        g, b = g.cpu(), b.cpu()
        assert (g - w).abs().max().item() <= ATOL
        assert (_centred(g) - _centred(w)).abs().max().item() <= \
            CENTRED_SHARE * _centred(w).std().item()
        limit = BF16_ATOL_SSD_SCORES if (name, i) == ("ssd", 1) else BF16_ATOL
        assert (b - g).abs().max().item() <= limit


def _decode(dec, tensors, fi):
    dims = ".".join(":".join(str(d) for d in reversed(t.shape)) for t in tensors)
    types = ",".join("float32" for _ in tensors)
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"num_tensors={len(tensors)},dimensions={dims},types={types} "
        f"! tensor_decoder {dec} frames-in={fi} ! tensor_sink name=out "
        "max-stored=0")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        pipe.get("in").push_buffer(Buffer(list(tensors)))
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type is MessageType.EOS, msg
    return [(bytes(np.asarray(b.tensors[0])),
             repr({k: b.meta[k] for k in ("detections", "keypoints")
                   if k in b.meta}),
             np.asarray(b.meta.get("class_map", 0)).tobytes()) for b in got]


DECODERS = [
    ("mode=bounding_boxes option1=mobilenet-ssd-postprocess option3=,30 "
     "option4=224:224", [(4, 3135, 4), (4, 3135, 91)]),
    ("mode=bounding_boxes option1=mobilenet-ssd-postprocess option3=,30 "
     "option4=224:224 option10=64", [(4, 3135, 4), (4, 3135, 91)]),
    ("mode=pose_estimation option1=224:224 option2=heatmap",
     [(4, 28, 28, 17)]),
    ("mode=image_segment option1=tflite-deeplab", [(4, 224, 224, 21)]),
    ("mode=tensor_region option1=8 option2=224:224", [(4, 3135, 4), (4, 3135)]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dec,shapes", DECODERS, ids=lambda v: str(v)[:40])
def test_reduce_on_card_equals_cpu(cuda_card, dec, shapes):
    """Quantized values plant ties for the top-k cap and the argmaxes."""
    rng = np.random.default_rng(7)
    arrays = [(np.floor(rng.random(s) * 16) / 16).astype(np.float32)
              for s in shapes]
    if dec.startswith("mode=bounding") or dec.startswith("mode=tensor_region"):
        arrays[0] = np.sort(arrays[0], axis=-1)
    cpu = _decode(dec, [torch.from_numpy(a) for a in arrays], 4)
    card = _decode(dec, [torch.from_numpy(a).to(cuda_card) for a in arrays], 4)
    assert cpu == card


@pytest.mark.cuda
def test_top_k_and_argmax_ties_on_card(cuda_card):
    rng = np.random.default_rng(8)
    s = torch.from_numpy((rng.integers(0, 5, (16, 3135)) / 4).astype(np.float32))
    v_cpu, i_cpu = top_k(s, 256)
    v_card, i_card = top_k(s.to(cuda_card), 256)
    assert torch.equal(i_cpu, i_card.cpu()) and torch.equal(v_cpu, v_card.cpu())
    assert torch.equal(s.argmax(-1), s.to(cuda_card).argmax(-1).cpu())
    assert torch.equal(s.argmax(-1), torch.from_numpy(s.numpy().argmax(-1)))


@pytest.mark.cuda
def test_nms_torch_on_card(cuda_card):
    rng = np.random.default_rng(9)
    c = rng.random((200, 2)).astype(np.float32)
    hw = rng.uniform(0.05, 0.4, (200, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([c - hw / 2, c + hw / 2], 1))
    scores = torch.from_numpy((rng.integers(1, 8, 200) / 8).astype(np.float32))
    k_cpu, v_cpu = nms_torch(boxes, scores, max_out=50)
    k_card, v_card = nms_torch(boxes.to(cuda_card), scores.to(cuda_card),
                               max_out=50)
    assert k_card.is_cuda
    assert torch.equal(k_cpu, k_card.cpu()) and torch.equal(v_cpu, v_card.cpu())
