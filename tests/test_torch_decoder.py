"""The port's tensor_decoder and its image_labeling, direct_video and
octet_stream modes (elements/decoder.py, decoders/) against
nnstreamer_tpu's: the golden bytes of tests/golden/, and the same label
and frame buffers from the same input batches on every path — the host
path (numpy batches, split per frame), the reduce path (a batch of torch
tensors reduced where it lies, one pull; JAX arrays in nnstreamer_tpu),
the legacy frames-in=1 meaning of a (B, C) buffer and the one-label-per-
frame guard. All comparisons are exact."""
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, DataType, MessageType, TensorSpec, TensorsInfo
from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, get, names
from nnstreamer_tpu_torch.runtime.parse import parse_launch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
sys.path.insert(0, GOLDEN)

from generate import cases  # noqa: E402

PORT_MODES = ("image_labeling", "direct_video", "octet_stream")
GOLDEN_CASES = [c for c in cases() if c[1] in PORT_MODES]


def _decoder(mode, options):
    cls = get(SubpluginKind.DECODER, mode)
    dec = cls()
    dec.init(list(options) + [None] * (12 - len(options)))
    return dec


@pytest.mark.parametrize("name,mode,options,arrays", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_bytes(name, mode, options, arrays):
    dec = _decoder(mode, options)
    info = TensorsInfo.of(*(TensorSpec(a.shape, DataType.from_any(a.dtype))
                            for a in arrays))
    out = dec.decode(Buffer([np.asarray(a) for a in arrays]), info)
    blob = b"".join(np.ascontiguousarray(np.asarray(t)).tobytes()
                    for t in out.tensors)
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as fh:
        assert blob == fh.read()


def test_registry_lists_the_modes():
    assert set(PORT_MODES) <= set(names(SubpluginKind.DECODER))
    with pytest.raises(KeyError, match="no decoder subplugin 'python3'"):
        get(SubpluginKind.DECODER, "python3")


def _run(pkg: str, dims: str, types: str, dec: str, bufs):
    """appsrc ! tensor_decoder <dec> ! tensor_sink in either package;
    returns the sink's buffers and the terminating message."""
    parse = parse_launch if pkg == "port" else jax_parse_launch
    pipe = parse(f"appsrc name=in caps=other/tensors,format=static,"
                 f"dimensions={dims},types={types} ! tensor_decoder {dec} "
                 "name=d ! tensor_sink name=out max-stored=0")
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
    return got, msg


def _wrap(pkg: str, where: str, arrays, offset=0):
    """One buffer of ``arrays``: numpy on the host, or device arrays (torch
    CPU tensors in the port, JAX arrays in nnstreamer_tpu)."""
    if where == "host":
        ts = [np.asarray(a) for a in arrays]
    elif pkg == "port":
        ts = [torch.from_numpy(np.array(a)) for a in arrays]
    else:
        ts = [jnp.asarray(a) for a in arrays]
    return (Buffer if pkg == "port" else JBuffer)(ts, offset=offset)


def _labels(bufs):
    return [(b.meta["label_indices"], b.meta["labels"],
             bytes(np.asarray(b.tensors[0])), b.offset) for b in bufs]


@pytest.fixture
def labels_file(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"l{i}\n" for i in range(7)))   # 10 classes
    return str(path)


def _scores(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("where", ["host", "device"])
def test_labeling_frames_in_matches(labels_file, where):
    """frames-in=4: four label buffers from one (4, 10) batch, each one
    label, equal to nnstreamer_tpu's on both its paths."""
    batches = [_scores(s, (4, 10)) for s in (1, 2)]
    dec = f"mode=image_labeling option1={labels_file} frames-in=4"
    got, msg = _run("port", "10:4", "float32", dec,
                    [_wrap("port", where, [b], i) for i, b in enumerate(batches)])
    assert msg.type is MessageType.EOS, msg
    assert len(got) == 8 and all(len(b.meta["labels"]) == 1 for b in got)
    want_idx = np.concatenate(batches).argmax(-1).tolist()
    assert [b.meta["label_index"] for b in got] == want_idx
    assert got[0].meta["label"] == (f"l{want_idx[0]}" if want_idx[0] < 7
                                    else str(want_idx[0]))
    for jwhere in ("host", "device"):
        want, _ = _run("jax", "10:4", "float32", dec,
                       [_wrap("jax", jwhere, [b], i) for i, b in enumerate(batches)])
        assert _labels(got) == _labels(want)


def test_reduce_path_pulls_only_labels(labels_file, monkeypatch):
    """A torch batch is reduced where it lies: the decoder's host decode()
    never sees the scores."""
    from nnstreamer_tpu_torch.decoders.simple import ImageLabeling

    def no_host(*a, **k):
        raise AssertionError("host decode() on a torch batch")

    monkeypatch.setattr(ImageLabeling, "decode", no_host)
    got, msg = _run("port", "10:4", "float32",
                    f"mode=image_labeling option1={labels_file} frames-in=4",
                    [_wrap("port", "device", [_scores(3, (4, 10))])])
    assert msg.type is MessageType.EOS, msg
    assert len(got) == 4


@pytest.mark.parametrize("where", ["host", "device"])
def test_labeling_fi1_keeps_legacy_batch(labels_file, where):
    """frames-in=1: a (B, C) buffer decodes to B labels in ONE buffer."""
    scores = _scores(4, (5, 10))
    dec = f"mode=image_labeling option1={labels_file}"
    got, msg = _run("port", "10:5", "float32", dec,
                    [_wrap("port", where, [scores])])
    want, _ = _run("jax", "10:5", "float32", dec,
                   [_wrap("jax", where, [scores])])
    assert msg.type is MessageType.EOS, msg
    assert len(got) == 1 and got[0].meta["label_indices"] == \
        scores.argmax(-1).tolist()
    assert _labels(got) == _labels(want)


def test_labeling_per_frame_d0_guard(labels_file):
    """A frame of (2, C) scores yields two labels on the host path; the
    reduce path must not flatten it into one, so it stays on the host."""
    scores = _scores(5, (4, 10))     # frames-in=2 → two frames of (2, 10)
    dec = f"mode=image_labeling option1={labels_file} frames-in=2"
    got, msg = _run("port", "10:4", "float32", dec,
                    [_wrap("port", "device", [scores])])
    assert msg.type is MessageType.EOS, msg
    assert [b.meta["label_indices"] for b in got] == [
        scores[:2].argmax(-1).tolist(), scores[2:].argmax(-1).tolist()]
    for where in ("host", "device"):
        want, _ = _run("jax", "10:4", "float32", dec,
                       [_wrap("jax", where, [scores])])
        assert _labels(got) == _labels(want)
    dec_obj = _decoder("image_labeling", [labels_file])
    frame = TensorsInfo.of(TensorSpec((2, 10), DataType.FLOAT32))
    assert dec_obj.make_reduce(frame) is None


@pytest.mark.parametrize("where", ["host", "device"])
def test_direct_video_frames_in(where):
    rng = np.random.default_rng(6)
    frames = (rng.standard_normal((4, 4, 6, 3)) * 200 + 100).astype(np.float32)
    got, msg = _run("port", "3:6:4:4", "float32",
                    "mode=direct_video frames-in=2",
                    [_wrap("port", where, [frames])])
    assert msg.type is MessageType.EOS, msg
    for jwhere in ("host", "device"):
        want, _ = _run("jax", "3:6:4:4", "float32",
                       "mode=direct_video frames-in=2",
                       [_wrap("jax", jwhere, [frames])])
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            a, b = np.asarray(g.tensors[0]), np.asarray(w.tensors[0])
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_octet_stream_element():
    ints = np.arange(-3, 5, dtype=np.int32).reshape(2, 4)
    got, _ = _run("port", "4:2", "int32", "mode=octet_stream",
                  [_wrap("port", "host", [ints])])
    want, _ = _run("jax", "4:2", "int32", "mode=octet_stream",
                   [_wrap("jax", "host", [ints])])
    assert bytes(np.asarray(got[0].tensors[0])) == \
        bytes(np.asarray(want[0].tensors[0])) == ints.tobytes()


def test_frames_in_must_divide_the_batch(labels_file):
    dec = f"mode=image_labeling option1={labels_file} frames-in=3"
    for pkg in ("port", "jax"):
        got, msg = _run(pkg, "10:4", "float32", dec,
                        [_wrap(pkg, "host", [_scores(7, (4, 10))])])
        assert msg.type.value == "error", (pkg, msg)
        assert "frames-in=3 does not divide" in msg.data["error"]
        assert got == []


def test_signature_warning_fires_once(caplog):
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder

    dec = TensorDecoder(mode="image_labeling")
    with caplog.at_level(logging.WARNING, logger="nnstreamer_tpu_torch"):
        for n in range(1, 40):
            dec._track_signature(Buffer([torch.zeros(n, 3)]))
    warned = [r for r in caplog.records if "distinct input signatures" in r.message]
    assert len(warned) == 1 and "32" in warned[0].message


def test_decoder_requires_mode():
    from nnstreamer_tpu_torch.elements.decoder import TensorDecoder
    from nnstreamer_tpu_torch.runtime.element import ElementError

    with pytest.raises(ElementError, match="'mode' property required"):
        TensorDecoder()
    with pytest.raises(ElementError, match="frames-in must be >= 1"):
        TensorDecoder(mode="octet_stream", frames_in=0)
    assert "image_labeling" in TensorDecoder(
        mode="octet_stream").get_property("sub-plugins").split(",")
