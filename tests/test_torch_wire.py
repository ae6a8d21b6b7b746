"""The port's wire formats against nnstreamer_tpu's: core/serialize.py
(``pack_tensors``/``unpack_tensors``, the NNST framing), the hand-rolled
protobuf and flatbuffers codecs (core/wire_{protobuf,flatbuf}.py), the
three serialization decoders (decoders/serialize.py) against the golden
bytes of tests/golden/ (made by tests/golden/generate.py), the three
converters, and the decoder → converter round trip on both packages.
Every comparison is byte-exact."""
import os
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import serialize as jser
from nnstreamer_tpu.core import wire_flatbuf as jfb
from nnstreamer_tpu.core import wire_protobuf as jpb
from nnstreamer_tpu.core.tensors import DataType as JDataType
from nnstreamer_tpu.core.tensors import TensorSpec as JTensorSpec
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, DataType, TensorFormat, TensorSpec, TensorsInfo
from nnstreamer_tpu_torch.core import serialize as tser
from nnstreamer_tpu_torch.core import wire_flatbuf as tfb
from nnstreamer_tpu_torch.core import wire_protobuf as tpb
from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, get
from nnstreamer_tpu_torch.runtime.parse import parse_launch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
sys.path.insert(0, GOLDEN)

from generate import cases  # noqa: E402

WIRE_MODES = ("protobuf", "flatbuf", "flexbuf")
GOLDEN_CASES = [c for c in cases() if c[1] in WIRE_MODES]


def _arrays(seed: int):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((2, 3)).astype(np.float32),
        rng.integers(-50, 50, (4,)).astype(np.int32),
        rng.integers(0, 255, (2, 2, 3)).astype(np.uint8),
        rng.standard_normal(5).astype(np.float64),
        rng.integers(-9, 9, (3, 1)).astype(np.int64),
        np.array(7, np.uint16),
        rng.standard_normal((2, 2)).astype(np.float16),
    ]


META_CASES = [
    ({}, None),
    ({"client_id": 7, "label": "cat", "scores": np.arange(3)}, 0.25),
    ({"nested": {"b": [1, 2], "a": np.float32(1.5)}}, 12.0),
]


@pytest.mark.parametrize("meta,pts", META_CASES, ids=["bare", "meta", "nested"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_bytes_equal_jax(seed, meta, pts):
    arrays = _arrays(seed)
    want = bytes(jser.pack_tensors(JBuffer(arrays, pts=pts, meta=dict(meta))))
    got = bytes(tser.pack_tensors(Buffer(arrays, pts=pts, meta=dict(meta))))
    assert got == want
    # torch tensors (host) pack to the same bytes as their numpy arrays
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    assert bytes(tser.pack_tensors(Buffer(tensors, pts=pts,
                                          meta=dict(meta)))) == want


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_reads_jax_frames(seed):
    arrays = _arrays(seed)
    blob = bytes(jser.pack_tensors(JBuffer(arrays, pts=3.5,
                                           meta={"k": [1, "x"]})))
    got = tser.unpack_tensors(blob)
    want = jser.unpack_tensors(blob)
    assert got.pts == want.pts == 3.5 and got.meta == want.meta
    for g, w in zip(got.tensors, want.tensors):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    # and the JAX package reads the port's
    back = jser.unpack_tensors(bytes(tser.pack_tensors(got)))
    assert [a.tobytes() for a in back.tensors] == [a.tobytes() for a in arrays]


def test_bfloat16_travels_as_its_bits():
    bits = np.array([0x3F80, 0xC040, 0x0001, 0x7F80], np.uint16)
    want = bytes(jser.pack_tensors(JBuffer([bits.view(ml_dtypes.bfloat16)])))
    t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    assert bytes(tser.pack_tensors(Buffer([t]))) == want
    out = tser.unpack_tensors(want).tensors[0]
    assert isinstance(out, torch.Tensor) and out.dtype is torch.bfloat16
    assert torch.equal(out, t)


def test_sparse_frames_equal_jax():
    idx = np.array([1, 5, 7], np.int32)
    vals = np.array([0.5, -2.0, 3.25], np.float32)
    idx2 = np.array([0], np.int32)
    vals2 = np.array([9], np.int32)
    jspecs = [JTensorSpec((2, 4), JDataType.FLOAT32),
              JTensorSpec((3,), JDataType.INT32)]
    tspecs = [TensorSpec((2, 4), DataType.FLOAT32),
              TensorSpec((3,), DataType.INT32)]
    want = bytes(jser.pack_tensors(JBuffer(
        [idx, vals, idx2, vals2], pts=1.0, meta={"sparse_specs": jspecs})))
    got = bytes(tser.pack_tensors(Buffer(
        [idx, vals, idx2, vals2], pts=1.0, meta={"sparse_specs": tspecs})))
    assert got == want
    back = tser.unpack_tensors(want)
    assert [s.shape for s in back.meta["sparse_specs"]] == [(2, 4), (3,)]
    for g, a in zip(back.tensors, [idx, vals, idx2, vals2]):
        assert g.tobytes() == a.tobytes()


@pytest.mark.parametrize("mutate", ["magic", "truncate", "count", "version",
                                    "payload"])
def test_corrupt_frames_raise_value_error_as_jax(mutate):
    blob = bytearray(jser.pack_tensors(JBuffer(_arrays(2)[:2], pts=1.0)))
    if mutate == "magic":
        blob[:4] = b"XXXX"
    elif mutate == "truncate":
        blob = blob[:len(blob) - 5]
    elif mutate == "count":
        blob[6:10] = (10 ** 6).to_bytes(4, "little")
    elif mutate == "version":
        blob[4:6] = (9).to_bytes(2, "little")
    else:
        blob[-30] ^= 0xFF
        blob = blob + b"\0"  # extra bytes after the last tensor are ignored
    results = []
    for unpack in (jser.unpack_tensors, tser.unpack_tensors):
        try:
            out = unpack(bytes(blob))
            results.append([np.asarray(t).tobytes() for t in out.tensors])
        except ValueError as e:
            results.append(type(e))
    assert results[0] == results[1]


def test_unserializable_meta_raises_as_jax():
    for pkg, B, pack in (("jax", JBuffer, jser.pack_tensors),
                         ("port", Buffer, tser.pack_tensors)):
        with pytest.raises(TypeError, match="not wire-serializable"):
            pack(B([np.zeros(2, np.float32)], meta={"bad": object()}))


WIRE_ARRAYS = [a for a in _arrays(3) if a.dtype != np.float16]


@pytest.mark.parametrize("fmt", list(TensorFormat), ids=lambda f: f.value)
@pytest.mark.parametrize("codec", ["protobuf", "flatbuf"])
def test_idl_encoders_equal_jax(codec, fmt):
    jmod, tmod = {"protobuf": (jpb, tpb), "flatbuf": (jfb, tfb)}[codec]
    from nnstreamer_tpu.core.tensors import TensorFormat as JFormat

    names = ["a", "", "ccc"] + [""] * (len(WIRE_ARRAYS) - 3)
    want = jmod.encode_tensors(WIRE_ARRAYS, names, fmt=JFormat(fmt.value),
                               rate=(30, 1))
    got = tmod.encode_tensors(WIRE_ARRAYS, names, fmt=fmt, rate=(30, 1))
    assert got == want
    arrays, got_names, got_fmt, rate = tmod.decode_tensors(want)
    assert got_names == names and got_fmt is fmt and rate == (30, 1)
    for g, a in zip(arrays, WIRE_ARRAYS):
        # the wire holds no rank 0: a scalar comes back with shape (1,)
        assert g.dtype == a.dtype and g.shape == np.atleast_1d(a).shape
        assert g.tobytes() == a.tobytes()


@pytest.mark.parametrize("codec", ["protobuf", "flatbuf"])
def test_idl_encoders_reject_unrepresentable_dtypes(codec):
    tmod = {"protobuf": tpb, "flatbuf": tfb}[codec]
    with pytest.raises(ValueError, match="not representable"):
        tmod.encode_tensors([np.zeros(2, np.float16)])


def _decoder(mode, options):
    cls = get(SubpluginKind.DECODER, mode)
    dec = cls()
    dec.init(list(options) + [None] * (12 - len(options)))
    return dec


@pytest.mark.parametrize("name,mode,options,arrays", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
@pytest.mark.parametrize("where", ["numpy", "torch"])
def test_decoder_golden_bytes(name, mode, options, arrays, where):
    dec = _decoder(mode, options)
    info = TensorsInfo.of(*(TensorSpec(a.shape, DataType.from_any(a.dtype))
                            for a in arrays))
    tensors = [np.asarray(a) if where == "numpy"
               else torch.from_numpy(np.array(a)) for a in arrays]
    out = dec.decode(Buffer(tensors), info)
    blob = b"".join(np.ascontiguousarray(np.asarray(t)).tobytes()
                    for t in out.tensors)
    with open(os.path.join(GOLDEN, f"{name}.bin"), "rb") as fh:
        assert blob == fh.read()


@pytest.mark.parametrize("mode", WIRE_MODES)
def test_decoders_refuse_bfloat16_like_jax(mode):
    info = TensorsInfo.of(TensorSpec((2,), DataType.BFLOAT16))
    caps = _decoder(mode, []).get_out_caps(info)
    assert (caps is None) == (mode != "flexbuf")


@pytest.mark.parametrize("mode", WIRE_MODES)
@pytest.mark.parametrize("fi", [1, 2])
def test_decoder_to_converter_round_trip_equals_jax(mode, fi):
    """``tensor_decoder mode=M ! tensor_converter`` gives back the frames,
    and the stream between them is nnstreamer_tpu's, byte for byte."""
    rng = np.random.default_rng(11)
    frames = [[rng.standard_normal((2, 4, 3)).astype(np.float32),
               rng.integers(0, 9, (2, 5)).astype(np.int32)]
              for _ in range(3)]
    line = ("appsrc name=in caps=other/tensors,format=static,num_tensors=2,"
            "dimensions=3:4:2.5:2,types=float32.int32 ! tensor_decoder "
            f"mode={mode} frames-in={fi} name=d ! tee name=t "
            "t. ! queue ! tensor_converter ! tensor_sink name=out "
            "t. ! queue ! tensor_sink name=wire")
    results = {}
    for pkg, parse in (("jax", jax_parse_launch), ("port", parse_launch)):
        pipe = parse(line)
        out, wire = [], []
        pipe.get("out").connect(out.append)
        pipe.get("wire").connect(wire.append)
        pipe.play()
        for f in frames:
            pipe.get("in").push_buffer(list(f))
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=30)
        pipe.stop()
        assert msg.type.value == "eos", (pkg, msg)
        results[pkg] = (out, wire)
    (jout, jwire), (tout, twire) = results["jax"], results["port"]
    assert len(twire) == len(jwire) == 3 * fi
    for g, w in zip(twire, jwire):
        assert np.asarray(g.tensors[0]).tobytes() == \
            np.asarray(w.tensors[0]).tobytes()
    if mode == "flexbuf" or fi == 1:
        want_frames = frames if fi == 1 else [
            [a[i:i + 1] for a in f] for f in frames for i in range(fi)]
        assert len(tout) == len(jout) == len(want_frames)
        for g, w, f in zip(tout, jout, want_frames):
            for a, b, c in zip(g.tensors, w.tensors, f):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes() \
                    == c.tobytes()


def test_converters_read_a_device_frame_as_its_host_copy():
    """A blob that arrives as a torch tensor (e.g. on the card) is read
    from its host copy."""
    arrays = WIRE_ARRAYS[:2]
    blob = np.frombuffer(tpb.encode_tensors(arrays), np.uint8).copy()
    conv = get(SubpluginKind.CONVERTER, "protobuf")()
    out = conv.convert(Buffer([torch.from_numpy(blob)]))
    for g, a in zip(out.tensors, arrays):
        assert g.tobytes() == a.tobytes()
