"""bfloat16 on the host path: the port against nnstreamer_tpu.

The port's host bfloat16 is a CPU ``torch.bfloat16`` tensor
(core/buffer.py); nnstreamer_tpu's is an ``ml_dtypes`` array. Three launch
lines that carry bfloat16 through host code are run through both packages
(the port with ``accelerator=cpu``) and compared exactly: the message that
ended the run, the caps at the sink, each buffer's dtype and shape, and
its raw bytes (bfloat16 as its 16-bit words).

1. ``tensor_src`` host mode emits bfloat16 buffers;
2. ``tensor_transform mode=arithmetic`` promotes a bfloat16 input to
   float32, as nnstreamer_tpu does for every non-numpy-floating input;
3. ``tensor_decoder mode=image_labeling`` / ``octet_stream`` decode a
   bfloat16 host tensor, also the one a ``tensor_src device=true`` buffer
   becomes at ``frames-in=1``."""
import numpy as np
import pytest
import torch

from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.runtime.parse import parse_launch


def _bytes_and_dtype(t):
    """(dtype name, shape, raw bytes) of a buffer tensor of either
    package; bfloat16 as its 16-bit words."""
    if isinstance(t, torch.Tensor):
        t = t.cpu()
        if t.dtype is torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    t.contiguous().view(torch.int16).numpy().tobytes())
        return str(t.numpy().dtype), tuple(t.shape), t.numpy().tobytes()
    a = np.asarray(t)
    return str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes()


def _run(parse, line: str):
    pipe = parse(line)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        msg = pipe.wait(timeout=60)
        caps = pipe.get("out").sinkpad.caps
    finally:
        pipe.stop()
    return (msg.type.value, str(caps),
            [[_bytes_and_dtype(t) for t in b.tensors] for b in got])


def _same(line: str, port_line: str):
    want = _run(jax_parse_launch, line)
    got = _run(parse_launch, port_line)
    assert got[0] == want[0] == "eos", (got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    return got


def test_tensor_src_emits_host_bfloat16():
    # ROADMAP §C fault 1
    line = ("tensor_src num-buffers=2 dimensions=4:3 types=bfloat16 "
            "pattern=counter {acc}! tensor_sink name=out")
    _, caps, bufs = _same(line.format(acc=""),
                          line.format(acc="accelerator=cpu "))
    assert "types=bfloat16" in caps
    assert [b[0][:2] for b in bufs] == [("bfloat16", (3, 4))] * 2
    # counter pattern: frame i is all i (0x3f80 is 1.0 in bfloat16)
    assert bufs[0][0][2] == b"\x00\x00" * 12
    assert bufs[1][0][2] == b"\x80\x3f" * 12


@pytest.mark.parametrize("pattern", ["random", "ones"])
def test_tensor_src_bfloat16_patterns(pattern):
    line = ("tensor_src num-buffers=3 dimensions=5:2 types=bfloat16 "
            f"pattern={pattern} seed=7 {{acc}}! tensor_sink name=out")
    _same(line.format(acc=""), line.format(acc="accelerator=cpu "))


@pytest.mark.parametrize("op", ["add:0.1", "mul:2"])
def test_arithmetic_promotes_bfloat16_to_float32(op):
    # ROADMAP §C fault 2
    line = ("tensor_src num-buffers=2 dimensions=6:4 types=float32 "
            "pattern=random seed=3 "
            "! tensor_transform mode=typecast option=bfloat16 {acc}"
            f"! tensor_transform mode=arithmetic option={op} {{acc}}"
            "! tensor_sink name=out")
    _, caps, bufs = _same(line.format(acc=""),
                          line.format(acc="accelerator=cpu "))
    assert "types=float32" in caps
    assert all(b[0][0] == "float32" for b in bufs)


@pytest.mark.parametrize("mode,nbytes", [("image_labeling", None),
                                         ("octet_stream", 24)])
def test_decoders_take_host_bfloat16(mode, nbytes):
    # ROADMAP §C fault 3: 3x4 bfloat16 scores, one label (or 24 raw
    # bytes) per buffer
    line = ("tensor_src num-buffers=3 dimensions=4:3 types=float32 "
            "pattern=random seed=5 "
            "! tensor_transform mode=typecast option=bfloat16 {acc}"
            f"! tensor_decoder mode={mode} ! tensor_sink name=out")
    _, _, bufs = _same(line.format(acc=""),
                       line.format(acc="accelerator=cpu "))
    assert len(bufs) == 3
    if nbytes is not None:
        assert all(len(b[0][2]) == nbytes for b in bufs)


def test_image_labeling_of_device_bfloat16_frames_in_1():
    # a tensor_src device=true buffer reaches the decoder's host path
    # through as_numpy() at frames-in=1; the port makes its frames with
    # a torch.Generator, so its label is held against the argmax of the
    # same tensor, and the counter pattern against the reference
    got = []
    pipe = parse_launch(
        "tensor_src device=true accelerator=cpu num-buffers=2 "
        "dimensions=7:1 types=bfloat16 pattern=random seed=2 name=src "
        "! tee name=t ! queue ! tensor_decoder mode=image_labeling "
        "frames-in=1 ! tensor_sink name=out "
        "t. ! queue ! tensor_sink name=raw")
    raw = []
    pipe.get("out").connect(got.append)
    pipe.get("raw").connect(raw.append)
    pipe.play()
    try:
        assert pipe.wait(timeout=60).type.value == "eos"
    finally:
        pipe.stop()
    assert len(got) == len(raw) == 2
    for lab, frame in zip(got, raw):
        scores = frame.tensors[0].float().reshape(-1)
        assert lab.meta["label_index"] == int(torch.argmax(scores))
    line = ("tensor_src device=true {acc}num-buffers=2 dimensions=7:1 "
            "types=bfloat16 pattern=counter ! tensor_decoder "
            "mode=image_labeling frames-in=1 ! tensor_sink name=out")
    _same(line.format(acc=""), line.format(acc="accelerator=cpu "))
