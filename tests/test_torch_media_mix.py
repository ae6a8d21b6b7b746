"""videomixer / compositor: the port against nnstreamer_tpu.

The reference's own mixer launch lines (tests/test_reference_launch_compat
.py: the decoder-overlay blend, z-order with gray/RGB/RGBA mixes, the
child-proxy ``sink_N::alpha`` and ``sink_N::zorder``) and seeded random
frames run through both packages; each sink's caps string and every
mixed frame's bytes must be equal. The blend is host float32 numpy in
both, so the comparison is exact."""
import time

import numpy as np
import pytest

from nnstreamer_tpu.registry.elements import _FACTORIES as J_FACTORIES
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.registry.elements import _FACTORIES
from nnstreamer_tpu_torch.runtime.parse import parse_launch


def _mix(parse, line, pushes, wait_eos=True):
    """Push (appsrc name, frame) pairs in order; the mixed frames and the
    sink's caps."""
    pipe = parse(line)
    out = []
    pipe.get("out").connect(
        lambda b: out.append(np.ascontiguousarray(np.asarray(b.tensors[0]))))
    pipe.play()
    try:
        for name, frame in pushes:
            pipe.get(name).push_buffer(frame)
        if wait_eos:
            for name in dict(pushes):
                pipe.get(name).end_of_stream()
            msg = pipe.wait(timeout=20)
            assert msg.type.name == "EOS", msg
        else:
            deadline = time.monotonic() + 10
            while not out and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        pipe.stop()
    return ([(a.dtype.name, a.shape, a.tobytes()) for a in out],
            str(pipe.get("out").sinkpad.caps))


def _both(line, pushes, wait_eos=True):
    want = _mix(jax_parse_launch, line, pushes, wait_eos)
    got = _mix(parse_launch, line, pushes, wait_eos)
    assert got[0], "no mixed frame"
    assert got == want
    return got


def _overlay():
    over = np.zeros((8, 8, 4), np.uint8)
    over[2, 3] = [255, 0, 0, 255]   # one opaque red pixel
    over[5, 5] = [0, 255, 0, 128]   # one half-green pixel
    return over


@pytest.mark.parametrize("mixer", ["videomixer", "compositor"])
def test_decoder_overlay_blend(mixer):
    """test_reference_launch_compat.py:93 — the transparent RGBA overlay
    over the source video."""
    got = _both(
        f"{mixer} name=mix ! tensor_sink name=out max-stored=2 "
        "appsrc name=base caps=video/raw,format=RGB,width=8,height=8 "
        "! mix.sink_0 "
        "appsrc name=over caps=video/raw,format=RGBA,width=8,height=8 "
        "! mix.sink_1",
        [("base", np.full((8, 8, 3), 100, np.uint8)), ("over", _overlay())])
    a = np.frombuffer(got[0][0][2], np.uint8).reshape(8, 8, 3)
    assert list(a[2, 3]) == [255, 0, 0] and list(a[0, 0]) == [100] * 3


@pytest.mark.parametrize("mixer", ["videomixer", "compositor"])
def test_zorder_and_gray_base(mixer):
    """:124 — sink_0 is the bottom layer even when linked last; a GRAY8
    base keeps its format."""
    over = np.zeros((4, 4, 4), np.uint8)
    over[1, 1] = [255, 255, 255, 255]
    got = _both(
        f"{mixer} name=mix ! tensor_sink name=out max-stored=2 "
        "appsrc name=over caps=video/raw,format=RGBA,width=4,height=4 "
        "! mix.sink_1 "
        "appsrc name=base caps=video/raw,format=GRAY8,width=4,height=4 "
        "! mix.sink_0",
        [("over", over), ("base", np.full((4, 4, 1), 50, np.uint8))])
    assert got[0][0][1] == (4, 4, 1)


def test_child_proxy_alpha():
    """:294 — ``sink_1::alpha=0.5`` scales an opaque RGB layer."""
    got = _both(
        "videomixer name=mix sink_0::zorder=0 sink_1::alpha=0.5 "
        "! tensor_converter ! tensor_sink name=out "
        "appsrc name=a caps=video/x-raw,format=RGB,width=2,height=2,"
        "framerate=0/1 ! mix.sink_0 "
        "appsrc name=b caps=video/x-raw,format=RGB,width=2,height=2,"
        "framerate=0/1 ! mix.sink_1",
        [("a", np.zeros((2, 2, 3), np.uint8)),
         ("b", np.full((2, 2, 3), 200, np.uint8))], wait_eos=False)
    assert set(got[0][0][2]) == {100}


def test_child_proxy_zorder_reorders_stack():
    """:324 — ``sink_N::zorder`` puts sink_0 on top."""
    got = _both(
        "videomixer name=mix sink_0::zorder=1 sink_1::zorder=0 "
        "! tensor_sink name=out max-stored=2 "
        "appsrc name=a caps=video/raw,format=RGB,width=2,height=2 "
        "! mix.sink_0 "
        "appsrc name=b caps=video/raw,format=RGB,width=2,height=2 "
        "! mix.sink_1",
        [("a", np.full((2, 2, 3), 10, np.uint8)),
         ("b", np.full((2, 2, 3), 200, np.uint8))], wait_eos=False)
    assert set(got[0][0][2]) == {10}


@pytest.mark.parametrize("base_fmt,layer_fmt", [
    ("RGB", "RGBA"), ("RGBA", "RGBA"), ("GRAY8", "RGB"), ("RGBA", "GRAY8"),
    ("RGB", "RGB")])
@pytest.mark.parametrize("alpha", ["", "sink_0::alpha=0.75 sink_1::alpha=0.4 "])
def test_random_frames_every_channel_mix(base_fmt, layer_fmt, alpha):
    """Seeded random frames over every channel mix, with and without
    child alphas on both layers: the base's alpha plane reattached, a
    gray base kept gray."""
    ch = {"RGB": 3, "RGBA": 4, "GRAY8": 1}
    rng = np.random.default_rng(7)
    pushes = []
    for _ in range(3):
        pushes.append(("a", rng.integers(0, 256, (6, 5, ch[base_fmt]))
                       .astype(np.uint8)))
        pushes.append(("b", rng.integers(0, 256, (6, 5, ch[layer_fmt]))
                       .astype(np.uint8)))
    got = _both(
        f"compositor name=mix {alpha}! tensor_sink name=out max-stored=4 "
        f"appsrc name=a caps=video/raw,format={base_fmt},width=5,height=6 "
        "! mix.sink_0 "
        f"appsrc name=b caps=video/raw,format={layer_fmt},width=5,height=6 "
        "! mix.sink_1", pushes)
    assert len(got[0]) == 3
    assert got[0][0][1] == (6, 5, ch[base_fmt])


def test_three_layers_pair_in_order():
    rng = np.random.default_rng(8)
    pushes = []
    for _ in range(4):
        for name, c in (("a", 3), ("b", 4), ("c", 4)):
            pushes.append((name, rng.integers(0, 256, (4, 4, c))
                           .astype(np.uint8)))
    got = _both(
        "videomixer name=mix ! tensor_sink name=out max-stored=8 "
        "appsrc name=a caps=video/raw,format=RGB,width=4,height=4 ! mix.sink_0 "
        "appsrc name=b caps=video/raw,format=RGBA,width=4,height=4 ! mix.sink_1 "
        "appsrc name=c caps=video/raw,format=RGBA,width=4,height=4 ! mix.sink_2",
        pushes)
    assert len(got[0]) == 4


def test_layer_size_mismatch_is_an_error():
    pipe = parse_launch(
        "compositor name=mix ! tensor_sink name=out "
        "appsrc name=a caps=video/raw,format=RGB,width=4,height=4 ! mix.sink_0 "
        "appsrc name=b caps=video/raw,format=RGBA,width=2,height=2 ! mix.sink_1")
    pipe.play()
    pipe.get("a").push_buffer(np.zeros((4, 4, 3), np.uint8))
    pipe.get("b").push_buffer(np.zeros((2, 2, 4), np.uint8))
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
    pipe.stop()
    assert msg is not None and "layer size" in msg.data["error"]


@pytest.mark.parametrize("name", ["videomixer", "compositor"])
def test_element_table_matches_the_reference(name):
    port, ref = _FACTORIES[name], J_FACTORIES[name]

    def table(cls):
        merged = {}
        for klass in reversed(cls.__mro__):
            merged.update(getattr(klass, "PROPERTIES", {}) or {})
        return {k: p.default for k, p in merged.items()}

    assert table(port) == table(ref)
    assert port.ACCEPT_CHILD_PROPS and ref.ACCEPT_CHILD_PROPS
    assert [(t.name_template, t.direction.name, t.presence.name)
            for t in port.SINK_TEMPLATES + port.SRC_TEMPLATES] == \
        [(t.name_template, t.direction.name, t.presence.name)
         for t in ref.SINK_TEMPLATES + ref.SRC_TEMPLATES]
