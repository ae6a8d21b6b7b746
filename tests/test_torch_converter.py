"""The port's raw-media front end against nnstreamer_tpu's on the same
launch lines: videotestsrc (every pattern and format), the media shims
(videoconvert, videoscale, imagefreeze, audiotestsrc, audioconvert, tee),
tensor_converter (video/audio/text/octet/tensors modes, frames-per-tensor,
construction errors, set-timestamp, the IDL MIMEs) and the lines of
tests/test_reference_launch_compat.py that use only ported elements
(copied here; that file is not edited).

Everything here is host numpy on both sides, so caps, dtypes and bytes
must be equal exactly."""
import logging

import numpy as np
import pytest

import nnstreamer_tpu.core as jcore
from nnstreamer_tpu.core import wire_protobuf as jwire_pb
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
import nnstreamer_tpu_torch.core as tcore
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.elements.media import (
    downstream_filter_caps,
    downstream_filter_fields,
)
from nnstreamer_tpu_torch.registry.elements import make_element
from nnstreamer_tpu_torch.runtime.parse import parse_launch

PARSERS = {"port": parse_launch, "jax": jax_parse_launch}


def _run(parse, line: str, pushes=(), timeout: float = 30):
    """Play ``line``; push each entry of ``pushes`` (a Buffer or a list of
    arrays) into ``in`` then EOS; return (message type, caps at ``out``,
    buffers at ``out``)."""
    pipe = parse(line)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        if "in" in pipe.elements:
            for p in pushes:
                pipe.get("in").push_buffer(p)
            pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=timeout)
        caps = pipe.get("out").sinkpad.caps
    finally:
        pipe.stop()
    return msg.type.value, caps, got


def _same(line: str, pushes_of=None, n: int = None):
    """Run ``line`` through both packages; assert equal caps, shapes,
    dtypes and bytes; return the port's buffers."""
    pj = pushes_of("jax") if pushes_of else ()
    pt = pushes_of("port") if pushes_of else ()
    wm, wc, want = _run(jax_parse_launch, line, pj)
    gm, gc, got = _run(parse_launch, line, pt)
    assert wm == gm == "eos", (wm, gm)
    assert str(gc) == str(wc)
    assert len(got) == len(want)
    if n is not None:
        assert len(got) == n
    for g, w in zip(got, want):
        assert g.num_tensors == w.num_tensors
        for a, b in zip(g.tensors, w.tensors):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        assert g.offset == w.offset
        assert (g.pts is None) == (w.pts is None)
        assert {k: v for k, v in g.meta.items() if not k.startswith("_")} \
            == {k: v for k, v in w.meta.items() if not k.startswith("_")}
    return got


FORMATS = ["RGB", "BGR", "GRAY8", "RGBA", "BGRx"]
PATTERNS = ["gradient", "solid", "checkers", "counter"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_videotestsrc_frames_equal_jax(pattern, fmt):
    got = _same(f"videotestsrc num-buffers=3 pattern={pattern} ! "
                f"video/x-raw,width=37,height=19,format={fmt} ! "
                "tensor_converter ! tensor_sink name=out", n=3)
    assert np.asarray(got[0].tensors[0]).shape[1:3] == (19, 37)


def test_videotestsrc_defaults_without_a_capsfilter():
    got = _same("videotestsrc num-buffers=2 ! tensor_converter ! "
                "tensor_sink name=out", n=2)
    assert np.asarray(got[0].tensors[0]).shape == (1, 240, 320, 3)


@pytest.mark.parametrize("target", FORMATS + ["BGRA"])
@pytest.mark.parametrize("source", ["RGB", "BGR", "GRAY8", "RGBA", "BGRx"])
def test_videoconvert_equal_jax(source, target):
    _same(f"videotestsrc num-buffers=2 pattern=gradient ! "
          f"video/x-raw,width=9,height=5,format={source} ! videoconvert ! "
          f"video/x-raw,format={target} ! tensor_converter ! "
          "tensor_sink name=out", n=2)


@pytest.mark.parametrize("size", ["17:13", "64:48", "40:30", "5:60"])
def test_videoscale_equal_jax(size):
    w, h = size.split(":")
    got = _same("videotestsrc num-buffers=2 pattern=checkers ! "
                "video/x-raw,width=40,height=30,format=RGB ! videoscale ! "
                f"video/x-raw,width={w},height={h} ! tensor_converter ! "
                "tensor_sink name=out", n=2)
    assert np.asarray(got[0].tensors[0]).shape == (1, int(h), int(w), 3)


def test_imagefreeze_passes_frames_through():
    _same("videotestsrc num-buffers=3 pattern=counter ! imagefreeze ! "
          "videoconvert ! video/x-raw,format=RGB,width=16,height=16 ! "
          "tensor_converter ! tensor_sink name=out", n=3)


@pytest.mark.parametrize("fmt", ["S8", "U8", "S16LE", "S32LE", "F32LE",
                                 "F64LE"])
@pytest.mark.parametrize("channels", [1, 2])
def test_audiotestsrc_equal_jax(fmt, channels):
    _same(f"audiotestsrc num-buffers=2 samplesperbuffer=100 freq=700 ! "
          f"audio/x-raw,format={fmt},rate=8000,channels={channels} ! "
          "tensor_converter ! tensor_sink name=out", n=2)


@pytest.mark.parametrize("target", ["S8", "U8", "S16LE", "S32LE", "F32LE",
                                    "F64LE"])
@pytest.mark.parametrize("source", ["U8", "S16LE", "F32LE"])
def test_audioconvert_equal_jax(source, target):
    _same(f"audiotestsrc num-buffers=2 samplesperbuffer=64 volume=0.9 ! "
          f"audio/x-raw,format={source},rate=16000 ! audioconvert ! "
          f"audio/x-raw,format={target} ! tensor_converter ! "
          "tensor_sink name=out", n=2)


@pytest.mark.parametrize("n_frames,fpt", [(7, 3), (6, 3), (4, 1), (5, 5)])
def test_video_frames_per_tensor_stacks_and_drops_partial(n_frames, fpt):
    got = _same(f"videotestsrc num-buffers={n_frames} pattern=counter ! "
                "video/x-raw,width=4,height=3,format=RGB ! "
                f"tensor_converter frames-per-tensor={fpt} ! "
                "tensor_sink name=out", n=n_frames // fpt)
    for i, b in enumerate(got):
        frames = np.asarray(b.tensors[0])
        assert frames.shape == (fpt, 3, 4, 3)
        assert [int(f[0, 0, 0]) for f in frames] == \
            list(range(i * fpt, (i + 1) * fpt))


def test_audio_frames_per_tensor_concatenates():
    got = _same("audiotestsrc num-buffers=5 samplesperbuffer=30 ! "
                "audio/x-raw,format=S16LE,rate=8000,channels=2 ! "
                "tensor_converter frames-per-tensor=2 ! tensor_sink name=out",
                n=2)
    assert np.asarray(got[0].tensors[0]).shape == (60, 2)


def _pcm_pushes(pkg):
    core = {"port": tcore, "jax": jcore}[pkg]
    pcm = (np.arange(24, dtype=np.int16) * 300).view(np.uint8)
    return [core.Buffer([pcm.copy()]), core.Buffer([pcm[:8].copy()])]


def test_audio_raw_pcm_bytes_are_viewed_per_caps():
    _same("appsrc name=in caps=audio/x-raw,format=S16LE,rate=8000,"
          "channels=2 ! tensor_converter ! tensor_sink name=out",
          _pcm_pushes, n=2)


def _octet_pushes(pkg):
    core = {"port": tcore, "jax": jcore}[pkg]
    rng = np.random.default_rng(5)
    return [core.Buffer([rng.integers(0, 256, 32).astype(np.uint8)])
            for _ in range(3)]


@pytest.mark.parametrize("props", [
    "input-dim=4:2 input-type=float32", "input-dim=8:4:1 input-type=uint8",
    "input-dim=16 input-type=int16", "",
    "input-dim=4:2 input-type=float32 frames-per-tensor=2",
])
@pytest.mark.parametrize("mime", ["application/octet-stream", "text/x-raw"])
def test_octet_and_text_modes_equal_jax(mime, props):
    _same(f"appsrc name=in caps={mime} ! tensor_converter {props} ! "
          "tensor_sink name=out", _octet_pushes)


def test_octet_size_mismatch_posts_an_error():
    line = ("appsrc name=in caps=application/octet-stream ! "
            "tensor_converter input-dim=5 input-type=uint8 ! "
            "tensor_sink name=out")
    for parse in PARSERS.values():
        pkg = "port" if parse is parse_launch else "jax"
        msg, _, got = _run(parse, line, _octet_pushes(pkg))
        assert msg == "error" and not got


def _tensor_pushes(pkg):
    core = {"port": tcore, "jax": jcore}[pkg]
    rng = np.random.default_rng(6)
    return [core.Buffer([rng.standard_normal((2, 3)).astype(np.float32),
                         np.arange(i + 1, dtype=np.int32)])
            for i in range(4)]


@pytest.mark.parametrize("fpt", [1, 2])
def test_tensors_mode_equal_jax(fpt):
    _same("appsrc name=in caps=other/tensors,format=flexible ! "
          f"tensor_converter frames-per-tensor={fpt} ! tensor_sink name=out",
          lambda pkg: _tensor_pushes(pkg)[:1] * 4)


@pytest.mark.parametrize("props", [
    "input-dim=0:4 input-type=uint8", "input-dim=4:4 input-type=uint9",
    "input-dim=4:x input-type=uint8", "frames-per-tensor=0",
])
def test_construction_errors_match_jax(props):
    line = ("appsrc caps=application/octet-stream ! "
            f"tensor_converter {props} ! tensor_sink")
    for parse in PARSERS.values():
        with pytest.raises(Exception):
            parse(line)


def test_custom_script_mode_is_refused():
    msg, _, _ = _run(parse_launch, "appsrc name=in caps=application/"
                     "octet-stream ! tensor_converter mode=custom-script:x.py "
                     "! tensor_sink name=out", _octet_pushes("port"))
    assert msg == "error"


@pytest.mark.parametrize("stamp", ["true", "false"])
def test_set_timestamp_stamps_the_output_not_the_shared_input(stamp):
    line = ("appsrc name=in caps=application/octet-stream ! tee name=t "
            "t. ! queue ! tensor_converter input-dim=32 input-type=uint8 "
            f"set-timestamp={stamp} ! tensor_sink name=out "
            "t. ! queue ! tensor_sink name=raw")
    for pkg, parse in PARSERS.items():
        pipe = parse(line)
        out, raw = [], []
        pipe.get("out").connect(out.append)
        pipe.get("raw").connect(raw.append)
        pipe.play()
        for b in _octet_pushes(pkg):
            pipe.get("in").push_buffer(b)
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()
        assert len(out) == len(raw) == 3, pkg
        assert all(b.pts is None for b in raw), pkg
        assert all((b.pts is not None) == (stamp == "true") for b in out), pkg
        if stamp == "true":
            pts = [b.pts for b in out]
            assert pts == sorted(pts), pkg


def _proto_pushes(pkg):
    core = {"port": tcore, "jax": jcore}[pkg]
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((2, 3)).astype(np.float32),
              rng.integers(-9, 9, (4,)).astype(np.int32)]
    blob = jwire_pb.encode_tensors(arrays, ["a", "b"], rate=(30, 1))
    return [core.Buffer([np.frombuffer(blob, np.uint8).copy()])]


def test_idl_mime_dispatches_to_converter_subplugin():
    got = _same("appsrc name=in caps=other/protobuf-tensor ! "
                "tensor_converter ! tensor_sink name=out", _proto_pushes, n=1)
    assert got[0].meta["tensor_names"] == ["a", "b"]
    assert got[0].meta["framerate"] == (30, 1)


def test_sub_plugins_lists_the_converters():
    from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, names

    assert {"flexbuf", "protobuf", "flatbuf"} <= set(
        names(SubpluginKind.CONVERTER))


# -- downstream capsfilter walk -------------------------------------------

def test_downstream_filter_walks_transparent_shims():
    pipe = parse_launch(
        "videotestsrc num-buffers=1 name=src ! videoconvert ! videoscale ! "
        "queue ! tee name=t t. ! video/x-raw,width=21,height=11,format=BGR ! "
        "tensor_converter ! tensor_sink name=out")
    fields = downstream_filter_fields(pipe.get("src"))
    assert (fields["width"], fields["height"], fields["format"]) == \
        (21, 11, "BGR")


def test_downstream_filter_stops_at_opaque_element(caplog):
    """tests/test_reference_launch_compat.py::
    test_caps_walk_stops_at_opaque_element, on the port."""
    pipe = parse_launch("videotestsrc num-buffers=1 name=src ! "
                        "tensor_converter ! tensor_sink name=out")
    with caplog.at_level(logging.INFO, logger="nnstreamer_tpu_torch"):
        assert downstream_filter_caps(pipe.get("src")) is None
    assert any("stopped at opaque element" in r.message
               for r in caplog.records)


def test_caps_walk_through_declared_transparent_element():
    """tests/test_reference_launch_compat.py::
    test_caps_walk_through_declared_transparent_element, on the port."""
    from nnstreamer_tpu_torch.core.caps import any_media_caps
    from nnstreamer_tpu_torch.registry.elements import register_element
    from nnstreamer_tpu_torch.runtime.element import Element
    from nnstreamer_tpu_torch.runtime.pad import PadDirection, PadTemplate

    @register_element
    class _SeeThrough(Element):
        ELEMENT_NAME = "test_torch_seethrough"
        CAPS_TRANSPARENT = True
        SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK,
                                      any_media_caps()), )
        SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC,
                                     any_media_caps()), )

        def chain(self, pad, buf):
            self.src_pads[0].push(buf)

    from nnstreamer_tpu_torch.registry.elements import _FACTORIES

    try:
        pipe = parse_launch(
            "videotestsrc num-buffers=1 name=src ! test_torch_seethrough ! "
            "video/x-raw,width=32,height=24,format=RGB,framerate=5/1 ! "
            "videoconvert ! tensor_converter ! tensor_sink name=out")
        caps = downstream_filter_caps(pipe.get("src"))
        fields = dict(caps.first.fields)
        assert fields["width"] == 32 and fields["height"] == 24
        got = []
        pipe.get("out").connect(got.append)
        pipe.play(); pipe.wait(timeout=30); pipe.stop()
    finally:
        # a test-only factory must not outlive the test: other files in
        # the same worker hold the registry against the reference's
        _FACTORIES.pop("test_torch_seethrough", None)
    assert len(got) == 1
    assert got[0].tensors[0].shape[1:3] == (24, 32)


def test_videotestsrc_adopts_the_capsfilter_framerate():
    src = make_element("videotestsrc")
    cf = parse_launch("videotestsrc name=s ! video/x-raw,framerate=(fraction)"
                      "25/1,width=8,height=4 ! tensor_sink name=out")
    caps = cf.get("s").get_src_caps()
    assert dict(caps.first.fields)["framerate"] == (25, 1)
    assert cf.get("s").props["framerate"] == 25.0
    assert src.props["framerate"] == 0.0


# -- the reference's own launch lines that use only ported elements --------

REFERENCE_LINES = [
    # nnstreamer_decoder_pose-style video front-end
    "videotestsrc num-buffers=2 ! videoconvert ! videoscale ! "
    "video/x-raw,width=64,height=48,format=RGB,framerate=5/1 ! "
    "tensor_converter ! tensor_sink",
    # spaces after commas + typed values (nnstreamer_decoder style)
    "videotestsrc num-buffers=1 ! videoconvert ! videoscale ! "
    "video/x-raw, width=160, height=120, framerate=(fraction)5/1, "
    "format=(string)RGB ! tee name=t t. ! queue ! tensor_converter ! "
    "tensor_sink",
    # audio chain (nnstreamer_flexbuf style)
    "audiotestsrc num-buffers=1 samplesperbuffer=800 ! audioconvert ! "
    "audio/x-raw,format=S16LE,rate=8000,channels=1 ! tensor_converter ! "
    "tensor_sink",
    # spaces around '=' in caps and props (runTest corpus idioms)
    "videotestsrc num-buffers=1 ! videoconvert ! "
    "video/x-raw, format = RGB, width=32, height=24, framerate=5/1 ! "
    "tee name =t t. ! queue ! tensor_converter ! tensor_sink",
    # the BGRx shim chain of test_shim_chain_runs_end_to_end
    "videotestsrc num-buffers=2 ! videoconvert ! videoscale ! "
    "video/x-raw, width=32, height=24, format=BGRx, framerate=30/1 ! "
    "tensor_converter ! tensor_sink",
    # test_audiotestsrc_sine_respects_downstream_caps
    "audiotestsrc num-buffers=1 samplesperbuffer=400 freq=1000 ! "
    "audioconvert ! audio/x-raw,format=F32LE,rate=8000,channels=2 ! "
    "tensor_converter ! tensor_sink",
    # is-live accepted (test_query_client_reference_property_spellings'
    # source half)
    "videotestsrc is-live=true num-buffers=1 ! tensor_converter ! "
    "tensor_sink",
]


@pytest.mark.parametrize("line", REFERENCE_LINES,
                         ids=[f"line{i}" for i in range(len(REFERENCE_LINES))])
def test_reference_line_runs_equal_to_jax(line):
    parse_launch(line)  # constructs
    _same(line.replace("! tensor_sink", "! tensor_sink name=out"))


def test_reference_shim_chain_shapes():
    got = _same(REFERENCE_LINES[4].replace("! tensor_sink",
                                           "! tensor_sink name=out"))
    a = np.asarray(got[0].tensors[0])
    assert a.shape == (1, 24, 32, 4) and a.dtype == np.uint8
    got = _same(REFERENCE_LINES[5].replace("! tensor_sink",
                                           "! tensor_sink name=out"))
    a = np.asarray(got[0].tensors[0])
    assert a.dtype == np.float32 and a.shape == (400, 2)
    assert np.abs(a).max() <= 1.0 and np.abs(a).max() > 0.5


def test_unsupported_audio_format_posts_an_error():
    msg, _, got = _run(parse_launch, "audiotestsrc num-buffers=1 ! "
                       "audio/x-raw,format=S24LE ! tensor_converter ! "
                       "tensor_sink name=out")
    assert msg == "error" and not got


def test_tee_shares_one_buffer_across_branches():
    pipe = parse_launch("appsrc name=in caps=other/tensors,format=static,"
                        "dimensions=2,types=int32 ! tee name=t "
                        "t. ! queue ! tensor_sink name=a "
                        "t. ! queue ! tensor_sink name=b")
    a, b = [], []
    pipe.get("a").connect(a.append)
    pipe.get("b").connect(b.append)
    pipe.play()
    pipe.get("in").push_buffer(np.array([1, 2], np.int32))
    pipe.get("in").end_of_stream()
    assert pipe.wait(timeout=30).type is MessageType.EOS
    pipe.stop()
    assert len(a) == len(b) == 1 and a[0] is b[0]
