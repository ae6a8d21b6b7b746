"""The MobileNet-v2 slice on the card (marker ``cuda``; skips without a
card). This file needs neither JAX nor nnstreamer_tpu, so it runs where
they are not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_mobilenet_cuda.py

The CPU build is held against nnstreamer_tpu in test_torch_mobilenet.py;
here the card's builds are held against the CPU build on the same seeded
weights: float32 within the CPU tolerance (1e-5 on the logits, 1% of the
centred logits' std) even with cuDNN's TF32 switched on process-wide,
bfloat16 within 5e-4 of float32 (about twice nnstreamer_tpu's own bf16-vs-
f32 gap of 2.28e-4 on its CPU)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import Buffer, MessageType
from nnstreamer_tpu_torch.models import mobilenet_v2 as tmb
from nnstreamer_tpu_torch.models._blocks import make_u8_entry
from nnstreamer_tpu_torch.runtime.parse import parse_launch

LOGIT_ATOL, CENTRED_SHARE, BF16_ATOL = 1e-5, 0.01, 5e-4
F32_U8 = make_u8_entry(replace(tmb.filter_model, compute_dtype="float32"))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _frames(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 127, (n, 224, 224, 3))
                            .astype(np.uint8))


def _centred(a):
    return a - a.mean(0, keepdim=True)


@pytest.mark.cuda
def test_f32_card_matches_cpu_with_tf32_on(cuda_card):
    x = _frames()
    cpu = F32_U8.make("cpu")
    want = cpu(x)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = F32_U8.make(cuda_card)
        got = card(x.to(cuda_card))
        assert torch.backends.cudnn.allow_tf32      # restored after the call
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert got.is_cuda and got.dtype is torch.float32
    got = got.cpu()
    assert (got - want).abs().max().item() <= LOGIT_ATOL
    err = (_centred(got) - _centred(want)).abs().max().item()
    assert err <= CENTRED_SHARE * _centred(want).std().item()
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
def test_bf16_card_near_f32(cuda_card):
    x = _frames().to(cuda_card)
    f32 = F32_U8.make(cuda_card)
    assert f32.dtype is torch.float32
    bf16 = tmb.filter_model_u8.make(cuda_card)          # auto = bf16 on a card
    assert bf16.dtype is torch.bfloat16
    a, b = f32(x), bf16(x)
    assert b.dtype is torch.float32
    assert (a - b).abs().max().item() <= BF16_ATOL


@pytest.mark.cuda
def test_decoder_reduce_on_card_equals_host(cuda_card):
    scores = torch.randn(64, 1001, generator=torch.Generator().manual_seed(0))
    res = {}
    for where, t in (("host", scores.numpy()), ("card", scores.to(cuda_card))):
        pipe = parse_launch(
            "appsrc name=in caps=other/tensors,format=static,"
            "dimensions=1001:64,types=float32 ! tensor_decoder "
            "mode=image_labeling frames-in=64 ! tensor_sink name=out "
            "max-stored=0")
        got = []
        pipe.get("out").connect(got.append)
        pipe.play()
        try:
            pipe.get("in").push_buffer(Buffer([t]))
            pipe.get("in").end_of_stream()
            msg = pipe.wait(timeout=60)
        finally:
            pipe.stop()
        assert msg.type is MessageType.EOS, msg
        res[where] = [b.meta["label_index"] for b in got]
    assert res["card"] == res["host"] == scores.argmax(-1).tolist()


@pytest.mark.cuda
def test_tensor_src_device_frames(cuda_card):
    pipe = parse_launch(
        "tensor_src device=true pattern=random num-buffers=3 "
        "dimensions=3:224:224:64 types=uint8 ! tensor_sink name=out "
        "max-stored=0")
    got = []
    pipe.get("out").connect(lambda b: got.append(b.tensors[0]))
    pipe.play()
    try:
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type is MessageType.EOS, msg
    assert len(got) == 3
    for t in got:
        assert t.is_cuda and t.dtype is torch.uint8
        assert tuple(t.shape) == (64, 224, 224, 3)
        assert t.min().item() >= 0 and t.max().item() < 127
    assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
def test_aggregator_window_stays_on_card(cuda_card):
    from nnstreamer_tpu_torch.core import Event, parse_caps_string
    from nnstreamer_tpu_torch.registry.elements import make_element

    agg = make_element("tensor_aggregator", frames_out=4)
    sink = make_element("tensor_sink", max_stored=0)
    make_element("appsrc").link(agg)
    agg.link(sink)
    got = []
    sink.connect(got.append)
    agg.handle_sink_event(agg.sinkpad, Event.caps(parse_caps_string(
        "other/tensors,format=static,dimensions=2:1,types=float32")))
    frames = [np.full((1, 2), i, np.float32) for i in range(8)]
    for i, f in enumerate(frames):       # host, card, then host again
        t = torch.from_numpy(f).to(cuda_card) if i == 2 else f
        agg.chain(agg.sinkpad, Buffer([t]))
    assert len(got) == 2 and all(b.tensors[0].is_cuda for b in got)
    assert torch.equal(torch.cat([b.tensors[0] for b in got]).cpu(),
                       torch.from_numpy(np.concatenate(frames)))


@pytest.mark.cuda
def test_filter_runs_on_card_by_default(cuda_card):
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        "dimensions=3:224:224:2,types=uint8 ! tensor_filter framework=torch "
        "model=nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8 "
        "name=f ! tensor_sink name=out max-stored=0")
    got = []
    pipe.get("out").connect(lambda b: got.append(b.tensors[0]))
    pipe.play()
    try:
        pipe.get("in").push_buffer(_frames(2).numpy())
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=120)
        dev = pipe.get("f").backend_device
    finally:
        pipe.stop()
    assert msg.type is MessageType.EOS, msg
    assert dev == torch.device("cuda:0")
    assert got[0].is_cuda and tuple(got[0].shape) == (2, 1001)
