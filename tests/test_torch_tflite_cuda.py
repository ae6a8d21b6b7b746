"""``.tflite`` models on the card (marker ``cuda``; skips without a card).
This file needs neither JAX nor nnstreamer_tpu nor TensorFlow:

    python -m pytest --noconftest -q -m cuda tests/test_torch_tflite_cuda.py

Phase 16 of chip_smoke.py in small form, on the int8 MobileNet-v2
fixture at batch 8 and the tiny per-channel fixture:

* int8 on the card gives int8-native's bytes, and the three device modes'
  outputs stay on cuda:0; fake-quant and float are within 2 LSB of the
  port's CPU run;
* the tiny fixture gives the CPU run's bytes in all four modes;
* the importer leaves the process's TF32 switches as they were;
* a fused transform → int8 filter line is captured once and gives the
  unfused line's bytes; a segment holding an int8-native filter never
  dispatches;
* int8-native takes card inputs and gives host outputs;
* datareposrc use-native=true reads the same samples in the same order
  as use-native=false;
* the depthwise FMA kernel equals its plain version bit for bit, one
  launch a call, at each stride, on 7x7 and 112x112 images and channel
  counts that are multiples of 4 but not of 32 (and one that is not a
  multiple of 4)."""
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.models.tflite_import import load_tflite
from nnstreamer_tpu_torch.runtime.parse import parse_launch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card"),
]

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MODEL = str(FIXTURES / "mobilenet_v2_1.0_224_int8.tflite")
TINY = str(FIXTURES / "tiny_int8_perchannel.tflite")
B = 8


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-128, 128, (n, 224, 224, 3)).astype(np.int8))


@pytest.fixture(scope="module")
def native8():
    return load_tflite(MODEL, {"quantized_exec": "int8-native",
                               "batch": str(B)})[0]


def test_int8_on_card_equals_native(native8):
    fn, _, out_info = load_tflite(MODEL, {"quantized_exec": "int8",
                                          "batch": str(B)})
    x = _frames(B)
    got = fn(x.cuda())[0]
    assert got.is_cuda and tuple(got.shape) == out_info.specs[0].shape
    np.testing.assert_array_equal(got.cpu().numpy(), native8(x)[0])


@pytest.mark.parametrize("mode", ["fake-quant", "float"])
def test_float_modes_within_2_lsb_of_cpu(mode):
    opts = {"quantized_exec": mode, "batch": "4"}
    x = _frames(4, seed=1)
    card = load_tflite(MODEL, opts)[0](x.cuda())[0]
    cpu = load_tflite(MODEL, opts, device="cpu")[0](x)[0]
    assert card.is_cuda
    assert int((card.cpu().int() - cpu.int()).abs().max()) <= 2


@pytest.mark.parametrize("mode", ["fake-quant", "float", "int8",
                                  "int8-native"])
def test_tiny_fixture_all_modes_equal_cpu(mode):
    opts = {"quantized_exec": mode, "batch": "4"}
    x = torch.from_numpy(np.random.default_rng(3).integers(
        -128, 127, (4, 16, 16, 3)).astype(np.int8))
    want = np.asarray(load_tflite(TINY, opts, device="cpu")[0](x)[0])
    fn = load_tflite(TINY, opts)[0]
    got = fn(x.cuda())[0]
    if mode == "int8-native":
        assert isinstance(got, np.ndarray)
    else:
        assert got.is_cuda
        got = got.cpu().numpy()
    np.testing.assert_array_equal(got, want)


def test_tf32_switches_untouched():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    for flags in ((True, True), (False, False)):
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.backends.cudnn.allow_tf32 = flags[1]
        try:
            fn = load_tflite(MODEL, {"batch": "2"})[0]
            fn(_frames(2).cuda())
            torch.cuda.synchronize()
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before[0]
            torch.backends.cudnn.allow_tf32 = before[1]


def _run(line, fuse=None):
    pipe = parse_launch(line, fuse=fuse)
    outs = []
    pipe.get("out").connect(lambda b: outs.append(b.tensors[0]))
    pipe.play()
    try:
        msg = pipe.wait(timeout=300)
    finally:
        pipe.stop()
    return pipe, msg, outs


def test_fused_line_captures_once_and_equals_unfused():
    line = ("tensor_src device=true pattern=random types=uint8 "
            f"dimensions=3:224:224:{B} num-buffers=3 ! tensor_transform "
            "mode=arithmetic option=typecast:int16,add:-128,typecast:int8 "
            f"name=t ! tensor_filter framework=torch model={MODEL} "
            f"custom=quantized_exec:int8,batch:{B} name=f ! tensor_sink "
            "name=out")
    fused, msg, a = _run(line, fuse=True)
    assert msg.type.name == "EOS"
    (seg,) = fused.fused_segments
    assert seg.stats["retraces"] == 1
    _, msg, b = _run(line, fuse=False)
    assert msg.type.name == "EOS"
    assert len(a) == len(b) == 3
    assert all(x.is_cuda and torch.equal(x, y) for x, y in zip(a, b))


def test_native_filter_takes_card_frames_gives_host_outputs():
    line = (f"tensor_src device=true pattern=random types=int8 "
            f"dimensions=3:224:224:{B} num-buffers=2 ! tensor_transform "
            "mode=typecast option=int8 name=t ! tensor_filter "
            f"framework=torch model={MODEL} "
            f"custom=quantized_exec:int8-native,batch:{B} name=f ! "
            "tensor_sink name=out")
    pipe, msg, outs = _run(line)
    assert msg.type.name == "EOS"
    # the transform and the filter form a segment at play; it defuses on
    # the first buffer (the filter has no stage) and never dispatches
    assert all(seg.stats["dispatches"] == 0 and seg.stats["defused"] >= 1
               for seg in pipe.fused_segments)
    assert len(outs) == 2 and all(not o.is_cuda for o in outs)


def test_datareposrc_native_feeds_card_in_python_order(tmp_path):
    data, meta = tmp_path / "f.raw", tmp_path / "f.json"
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions="
        f"3:224:224:{B},types=int8 ! datareposink location={data} "
        f"json={meta}")
    pipe.play()
    for k in range(3):
        pipe.get("in").push_buffer(_frames(B, seed=k).numpy())
    pipe.get("in").end_of_stream()
    pipe.wait(timeout=60)
    pipe.stop()
    got = {}
    for native in (True, False):
        line = (f"datareposrc location={data} json={meta} epochs=2 "
                f"is-shuffle=true use-native={str(native).lower()} ! "
                f"tensor_filter framework=torch model={MODEL} "
                f"custom=quantized_exec:int8,batch:{B} ! tensor_sink "
                "name=out")
        p = parse_launch(line)
        order, outs = [], []
        p.get("out").connect(lambda b, o=order, q=outs: (
            o.append(b.offset), q.append(b.tensors[0].cpu())))
        p.play()
        p.wait(timeout=300)
        p.stop()
        got[native] = (order, outs)
    assert got[True][0] == got[False][0] and len(got[True][0]) == 6
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))


# the fixture's depthwise shapes (3x3 SAME at strides 1 and 2), with and
# without the reassociated centre tap of a fake-quantized input; VALID
# padding, and tiles and channel blocks cut short at the edges
@pytest.mark.parametrize("n,hw,c,stride,padding,scale", [
    (4, 112, 32, 1, "SAME", 0.0204), (4, 112, 96, 2, "SAME", None),
    (3, 7, 960, 1, "SAME", 0.05), (2, 9, 5, 2, "VALID", None),
    (1, 14, 576, 1, "SAME", None), (2, 15, 40, 2, "SAME", 0.05),
    (2, 13, 144, 1, "SAME", 0.05)])
def test_depthwise_fma_kernel_equals_its_plain_version(n, hw, c, stride,
                                                       padding, scale):
    from nnstreamer_tpu_torch.models.tflite_import import explicit_padding
    from nnstreamer_tpu_torch.ops.depthwise_fma import (depthwise_fma,
                                                        depthwise_fma_plain)

    g = torch.Generator(device="cuda").manual_seed(hw + c)
    if scale is None:
        x = torch.randn(n, hw, hw, c, device="cuda", generator=g)
    else:  # a fake-quantized activation k * s
        q = torch.randint(-128, 128, (n, hw, hw, c), device="cuda",
                          generator=g).float()
        x = q * torch.tensor(scale, device="cuda")
    w = torch.randn(1, 3, 3, c, device="cuda", generator=g) / 3
    oh, ow, pads = explicit_padding(hw, hw, 3, 3, (stride, stride), (1, 1),
                                    padding)
    args = (x, w, (stride, stride), (1, 1), pads, (oh, ow), scale)
    before = depthwise_fma.launches
    got = depthwise_fma(*args)
    assert depthwise_fma.launches == before + 1
    assert torch.equal(got, depthwise_fma_plain(*args))
    cpu = depthwise_fma(x.cpu(), w.cpu(), *args[2:])
    assert torch.equal(got.cpu(), cpu)


# the redesigned kernel's tiles: each stride, whole small images and
# wide tiles of large ones, channel runs that fill no 32-channel block
@pytest.mark.parametrize("stride", (1, 2))
@pytest.mark.parametrize("n,hw,c,scale", [
    (3, 7, 960, 0.05), (2, 7, 20, 0.03), (2, 112, 32, 0.0204),
    (1, 112, 36, None), (2, 56, 44, 0.02), (2, 14, 12, None),
    (1, 30, 6, 0.05)])
def test_depthwise_fma_kernel_tiles_equal_its_plain_version(n, hw, c, scale,
                                                           stride):
    from nnstreamer_tpu_torch.models.tflite_import import explicit_padding
    from nnstreamer_tpu_torch.ops.depthwise_fma import (depthwise_fma,
                                                        depthwise_fma_plain)

    g = torch.Generator(device="cuda").manual_seed(hw * c + stride)
    if scale is None:
        x = torch.randn(n, hw, hw, c, device="cuda", generator=g)
    else:  # a fake-quantized activation k * s
        q = torch.randint(-255, 256, (n, hw, hw, c), device="cuda",
                          generator=g).float()
        x = q * torch.tensor(scale, device="cuda")
    w = torch.randn(1, 3, 3, c, device="cuda", generator=g) / 3
    oh, ow, pads = explicit_padding(hw, hw, 3, 3, (stride, stride), (1, 1),
                                    "SAME")
    args = (x, w, (stride, stride), (1, 1), pads, (oh, ow), scale)
    before = depthwise_fma.launches
    got = depthwise_fma(*args)
    assert depthwise_fma.launches == before + 1
    assert torch.equal(got, depthwise_fma_plain(*args))


# the kernel is built for the listed shapes' window alone; the plain
# version (the CPU path) takes any
@pytest.mark.parametrize("k,mult,stride,dil", [
    (5, 1, 1, 1), (2, 1, 1, 1), (3, 2, 1, 1), (3, 1, 1, 2), (3, 1, 3, 1)])
def test_depthwise_fma_kernel_refuses_other_windows(k, mult, stride, dil):
    from nnstreamer_tpu_torch.models.tflite_import import explicit_padding
    from nnstreamer_tpu_torch.ops.depthwise_fma import depthwise_fma

    x = torch.randn(1, 9, 9, 4, device="cuda")
    w = torch.randn(1, k, k, 4 * mult, device="cuda")
    oh, ow, pads = explicit_padding(9, 9, k, k, (stride, stride), (dil, dil),
                                    "SAME")
    before = depthwise_fma.launches
    with pytest.raises(ValueError, match="3x3 window"):
        depthwise_fma(x, w, (stride, stride), (dil, dil), pads, (oh, ow))
    assert depthwise_fma.launches == before
