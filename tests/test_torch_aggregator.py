"""The port's tensor_aggregator (elements/aggregator.py) against
nnstreamer_tpu's on the same streams: frames-in/out/flush, frames-dim,
concat vs stack, the negotiated caps, and the window's residency — numpy
streams stay numpy, a window that a device frame entered stays on the
device (torch tensors in the port, JAX arrays in nnstreamer_tpu) with
later host frames uploaded into it — and the reset on EOS and on a
replay. Outputs are compared exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.registry.elements as jreg
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.registry.elements as treg

PKGS = {"port": (tcore, treg), "jax": (jcore, jreg)}


def _element(pkg: str, props: dict, caps: str):
    core, reg = PKGS[pkg]
    agg = reg.make_element("tensor_aggregator", **props)
    sink = reg.make_element("tensor_sink", max_stored=0)
    # linked upstream, so that caps on the sink pad negotiate the src pad;
    # events and buffers are handed to the aggregator directly
    reg.make_element("appsrc").link(agg)
    agg.link(sink)
    got = []
    sink.connect(got.append)
    agg.handle_sink_event(agg.sinkpad,
                          core.Event.caps(core.parse_caps_string(caps)))
    return agg, sink, got


def _buf(pkg: str, a: np.ndarray, device: bool, offset: int):
    core = PKGS[pkg][0]
    if device:
        t = torch.from_numpy(a.copy()) if pkg == "port" else jnp.asarray(a)
    else:
        t = a
    return core.Buffer([t], offset=offset)


def _run(pkg, props, caps, frames, kinds):
    agg, sink, got = _element(pkg, props, caps)
    for i, (a, dev) in enumerate(zip(frames, kinds)):
        agg.chain(agg.sinkpad, _buf(pkg, a, dev, i))
    agg.handle_sink_event(agg.sinkpad, PKGS[pkg][0].Event.eos())
    return got, str(sink.sinkpad.caps)


def _where(t) -> str:
    if isinstance(t, np.ndarray):
        return "host"
    if isinstance(t, (torch.Tensor, jax.Array)):
        return "device"
    raise TypeError(type(t))


def _dims(shape) -> str:
    return ":".join(str(d) for d in reversed(shape))


# (frames-in, frames-out, frames-flush, frames-dim, concat, buffer shape)
CASES = [
    (1, 4, 0, 0, True, (1, 3, 2)),     # the bench line's batching
    (1, 3, 1, 0, True, (1, 2)),        # sliding window, step 1
    (2, 3, 0, 0, True, (2, 2, 2)),     # two frames per buffer
    (1, 2, 0, 1, True, (3, 1, 2)),     # frames along axis 1
    (1, 3, 2, 0, False, (2, 2)),       # stack on a new axis, overlap 1
    (2, 4, 3, 0, False, (2, 3)),
]
STREAMS = {
    "host": [False] * 8,
    "device": [True] * 8,
    "host-then-device": [False] * 3 + [True] * 5,
    "device-then-host": [True] * 3 + [False] * 5,
}


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_matches_jax(case, stream):
    fi, fo, flush, dim, concat, shape = case
    props = dict(frames_in=fi, frames_out=fo, frames_flush=flush,
                 frames_dim=dim, concat=concat)
    caps = (f"other/tensors,format=static,dimensions={_dims(shape)},"
            "types=float32")
    rng = np.random.default_rng(fi * 10 + fo)
    frames = [rng.standard_normal(shape).astype(np.float32) for _ in range(8)]
    kinds = STREAMS[stream]
    got, got_caps = _run("port", props, caps, frames, kinds)
    want, want_caps = _run("jax", props, caps, frames, kinds)
    assert got_caps == want_caps and "dimensions=" in got_caps
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gt, wt = g.tensors[0], w.tensors[0]
        assert _where(gt) == _where(wt)
        assert tuple(gt.shape) == tuple(wt.shape)
        np.testing.assert_array_equal(np.asarray(gt), np.asarray(wt))
        assert g.offset == w.offset


def test_bench_line_caps():
    """dimensions=3:224:224:1 batched by 64 along frames-dim 0."""
    _, sink, _ = _element("port", dict(frames_out=64),
                          "other/tensors,format=static,"
                          "dimensions=3:224:224:1,types=uint8")
    assert str(sink.sinkpad.caps) == ("other/tensors,format=static,"
                                      "num_tensors=1,dimensions=3:224:224:64,"
                                      "types=uint8")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_eos_and_replay_reset_the_window(pkg):
    core = PKGS[pkg][0]
    caps = "other/tensors,format=static,dimensions=2:1,types=float32"
    agg, _, got = _element(pkg, dict(frames_out=3), caps)
    frame = [np.full((1, 2), i, np.float32) for i in range(8)]
    for i in range(2):
        agg.chain(agg.sinkpad, core.Buffer([frame[i]]))
    agg.handle_sink_event(agg.sinkpad, core.Event.eos())   # drops 0, 1
    for i in range(2, 4):
        agg.chain(agg.sinkpad, core.Buffer([frame[i]]))
    agg.reset_flow()                                        # drops 2, 3
    agg.handle_sink_event(agg.sinkpad,
                          core.Event.caps(core.parse_caps_string(caps)))
    for i in range(4, 7):
        agg.chain(agg.sinkpad, core.Buffer([frame[i]]))
    assert len(got) == 1
    np.testing.assert_array_equal(np.asarray(got[0].tensors[0])[:, 0],
                                  [4, 5, 6])


def test_flexible_stream_gets_flexible_caps():
    for pkg in ("port", "jax"):
        _, sink, _ = _element(pkg, dict(frames_out=2),
                              "other/tensors,format=flexible")
        assert "format=flexible" in str(sink.sinkpad.caps)


def test_frames_dim_out_of_range():
    from nnstreamer_tpu_torch.runtime.element import ElementError

    with pytest.raises(ElementError, match="frames-dim 3 out of range"):
        _element("port", dict(frames_dim=3),
                 "other/tensors,format=static,dimensions=2:1,types=float32")


def _device_src_frames(pkg: str, pattern: str, types: str, seed: int = 0):
    """tensor_src device=true ! tensor_sink; the port's frames are made on
    the CPU here (accelerator=cpu), nnstreamer_tpu's on JAX's CPU."""
    from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    extra = " accelerator=cpu" if pkg == "port" else ""
    parse = parse_launch if pkg == "port" else jax_parse_launch
    pipe = parse(f"tensor_src device=true{extra} pattern={pattern} seed={seed} "
                 f"num-buffers=3 dimensions=3:4:5:2 types={types} "
                 "! tensor_sink name=out max-stored=0")
    got = []
    pipe.get("out").connect(lambda b: got.append(b.tensors[0]))
    pipe.play()
    try:
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type.value == "eos", (pkg, msg)
    return got


@pytest.mark.parametrize("types", ["uint8", "float32"])
@pytest.mark.parametrize("pattern", ["zeros", "ones", "counter", "random"])
def test_device_src_matches_jax(pattern, types):
    """Frames born on the device: the same values as nnstreamer_tpu's for
    the fixed patterns; for random ones (torch.Generator vs jax.random)
    the same shape, dtype and range — integers in [0, 127), floats in
    [0, 1) — and the same frames again from the same seed."""
    got = _device_src_frames("port", pattern, types)
    want = _device_src_frames("jax", pattern, types)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and isinstance(w, jax.Array)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (2, 5, 4, 3)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        if pattern != "random":
            np.testing.assert_array_equal(g.numpy(), w)
        elif types == "uint8":
            assert g.min().item() >= 0 and g.max().item() < 127
        else:
            assert g.min().item() >= 0.0 and g.max().item() < 1.0
    if pattern == "random":
        assert not torch.equal(got[0], got[1])
        again = _device_src_frames("port", pattern, types)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        other = _device_src_frames("port", pattern, types, seed=1)
        assert not torch.equal(got[0], other[0])
