"""datareposrc / datareposink and tensor_src_iio: the port against
nnstreamer_tpu.

datarepo: the reference's cases (tests/test_elements.py::TestDataRepo and
the tensors-sequence case) run through both packages with every sink
buffer compared exactly, and the files are interchangeable: a repo that
either package writes reads back byte-exact in the other, bfloat16
included (its bit patterns through a uint16 view on both sides).

tensor_src_iio: the cases of tests/test_mqtt_iio.py on the same fake
sysfs tree in both packages (polled and buffered reads, raw mode, the
scan-element type grammar and layout); the float32 scaling is the same
numpy arithmetic in both, so the comparison is exact."""
import json
import os

import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements import iio as jiio
from nnstreamer_tpu.registry.elements import _FACTORIES as J_FACTORIES
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.core.buffer import bf16_bits
from nnstreamer_tpu_torch.elements import iio
from nnstreamer_tpu_torch.registry.elements import _FACTORIES
from nnstreamer_tpu_torch.runtime.parse import parse_launch

PARSERS = {"ref": jax_parse_launch, "port": parse_launch}


def rec(t):
    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bfloat16:
            return ("bfloat16", tuple(t.shape), bf16_bits(t).tobytes())
        t = t.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(t))
    if a.dtype.name == "bfloat16":
        return ("bfloat16", a.shape, a.view(np.uint16).tobytes())
    return (a.dtype.name, a.shape, a.tobytes())


def collect(parse, line, timeout=20):
    pipe = parse(line)
    got = []
    pipe.get("out").connect(
        lambda b: got.append(tuple(rec(t) for t in b.tensors)))
    pipe.play()
    try:
        msg = pipe.wait(timeout=timeout)
    finally:
        pipe.stop()
    assert msg.type.name == "EOS", msg
    return got, str(pipe.get("out").sinkpad.caps)


def write_repo(parse, d, src, name="d"):
    data, meta = os.path.join(d, f"{name}.dat"), os.path.join(d, f"{name}.json")
    parse(f"{src} ! datareposink location={data} json={meta}").run(timeout=20)
    return data, meta


# -- datarepo --------------------------------------------------------------

@pytest.mark.parametrize("props", [
    "start-sample-index=1 stop-sample-index=3 epochs=2",
    "is-shuffle=true seed=3",
    "is-shuffle=true seed=3 epochs=3 start-epoch=1",
    "tensors-sequence=1,0",
    "stop-sample-index=-1 epochs=0",
])
def test_reader_matches_the_reference(tmp_path, props):
    data, meta = write_repo(
        parse_launch, str(tmp_path),
        "tensor_src num-buffers=8 dimensions=2.3 types=float32 "
        "pattern=counter")
    line = (f"datareposrc location={data} json={meta} use-native=false "
            f"{props} ! tensor_sink name=out")
    want = collect(jax_parse_launch, line)
    got = collect(parse_launch, line)
    assert got == want and got[0]


def test_write_then_read(tmp_path):
    data, meta = write_repo(parse_launch, str(tmp_path),
                            "tensor_src num-buffers=5 dimensions=3 "
                            "types=float32 pattern=counter")
    with open(meta) as fh:
        assert json.load(fh)["total_samples"] == 5
    got, _ = collect(parse_launch,
                     f"datareposrc location={data} json={meta} "
                     "start-sample-index=1 stop-sample-index=3 epochs=2 ! "
                     "tensor_sink name=out")
    assert len(got) == 6
    assert got[0][0][2] == np.ones(3, np.float32).tobytes()


def test_shuffle_is_reproducible_and_shuffled(tmp_path):
    data, meta = write_repo(parse_launch, str(tmp_path),
                            "tensor_src num-buffers=8 dimensions=1 "
                            "types=float32 pattern=counter")
    line = (f"datareposrc location={data} json={meta} is-shuffle=true "
            "seed=3 ! tensor_sink name=out")
    a, b = collect(parse_launch, line)[0], collect(parse_launch, line)[0]
    vals = [np.frombuffer(x[0][2], np.float32)[0] for x in a]
    assert a == b and vals != sorted(vals)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("types", ["float32.int16", "uint8.float16",
                                   "int64"])
def test_files_are_interchangeable(tmp_path, writer, reader, types):
    n = len(types.split("."))
    dims = ".".join(["4:2", "3"][:n])
    src = (f"tensor_src num-buffers=4 dimensions={dims} types={types} "
           "pattern=random")
    data, meta = write_repo(PARSERS[writer], str(tmp_path), src)
    # what the writer wrote, read back by the writer itself
    line = (f"datareposrc location={data} json={meta} use-native=false ! "
            "tensor_sink name=out")
    want = collect(PARSERS[writer], line)
    got = collect(PARSERS[reader], line)
    assert got == want and len(got[0]) == 4
    with open(meta) as fh:
        m = json.load(fh)
    assert os.path.getsize(data) == m["total_samples"] * m["sample_size"]


BF16_STREAM = ("tensor_src num-buffers=3 dimensions=4:2.5 "
               "types=bfloat16.int32 pattern=counter")


def reference_format_repo(d, samples):
    """A repo in nnstreamer_tpu's format — its caps string in the JSON,
    each sample's tensors' bytes in order — from ``ml_dtypes`` arrays:
    the file nnstreamer_tpu's datareposink would write for them."""
    from nnstreamer_tpu.core import TensorsInfo as JInfo
    from nnstreamer_tpu.core import caps_from_tensors_info as jcaps
    from nnstreamer_tpu.core.tensors import TensorSpec as JSpec

    data, meta = os.path.join(d, "r.dat"), os.path.join(d, "r.json")
    info = JInfo.of(*(JSpec(a.shape, a.dtype.name) for a in samples[0]))
    with open(data, "wb") as fh:
        for sample in samples:
            for a in sample:
                fh.write(np.ascontiguousarray(a).tobytes())
    with open(meta, "w") as fh:
        json.dump({"gst_caps": str(jcaps(info)),
                   "total_samples": len(samples),
                   "sample_size": info.nbytes}, fh)
    return data, meta


def test_bfloat16_files_read_the_same_in_both(tmp_path):
    """A bfloat16 repo either package holds reads back byte-exact in the
    other: the port's datareposink file, and a file in nnstreamer_tpu's
    format built from its ``ml_dtypes`` arrays (its own datareposink
    cannot write bfloat16, see ROADMAP.md §C)."""
    import ml_dtypes

    d = str(tmp_path)
    data, meta = write_repo(parse_launch, d, BF16_STREAM)
    line = (f"datareposrc location={data} json={meta} use-native=false ! "
            "tensor_sink name=out")
    got = collect(parse_launch, line)
    assert got == collect(jax_parse_launch, line) and len(got[0]) == 3
    samples = [(np.full((2, 4), k, ml_dtypes.bfloat16),
                np.full((5,), k, np.int32)) for k in range(3)]
    rdata, rmeta = reference_format_repo(d, samples)
    assert open(rdata, "rb").read() == open(data, "rb").read()
    assert json.load(open(rmeta)) == json.load(open(meta))
    line = (f"datareposrc location={rdata} json={rmeta} use-native=false ! "
            "tensor_sink name=out")
    assert collect(parse_launch, line) == collect(jax_parse_launch, line) \
        == got


def test_written_bytes_equal_the_references(tmp_path):
    """The same stream written by both packages gives the same two files."""
    src = ("tensor_src num-buffers=3 dimensions=4:2.5 types=float16.int32 "
           "pattern=counter")
    (rd, rj), (pd, pj) = [write_repo(PARSERS[k], str(tmp_path), src, k)
                          for k in PARSERS]
    assert open(rd, "rb").read() == open(pd, "rb").read()
    assert json.load(open(rj)) == json.load(open(pj))


def test_caps_property_overrides_the_json(tmp_path):
    data, meta = write_repo(parse_launch, str(tmp_path),
                            "tensor_src num-buffers=2 dimensions=4 "
                            "types=float32 pattern=counter")
    got, caps = collect(parse_launch,
                        f"datareposrc location={data} json={meta} "
                        "caps=other/tensors,format=static,dimensions=2:2,"
                        "types=int32 ! tensor_sink name=out")
    assert "types=int32" in caps and got[1][0][:2] == ("int32", (2, 2))


@pytest.mark.parametrize("name", ["datareposrc", "datareposink",
                                  "tensor_src_iio"])
def test_element_table_matches_the_reference(name):
    def table(cls):
        merged = {}
        for klass in reversed(cls.__mro__):
            merged.update(getattr(klass, "PROPERTIES", {}) or {})
        return {k: p.default for k, p in merged.items()}

    port, ref = _FACTORIES[name], J_FACTORIES[name]
    assert table(port) == table(ref)
    assert getattr(port, "PROP_ALIASES", {}) == getattr(ref, "PROP_ALIASES", {})


# -- tensor_src_iio --------------------------------------------------------

def fake_iio(tmp_path, scan_type="le:s16/16>>0"):
    base = tmp_path / "iio"
    d = base / "iio:device0"
    scan = d / "scan_elements"
    scan.mkdir(parents=True)
    (d / "name").write_text("fake_accel\n")
    (d / "in_scale").write_text("0.5\n")
    (d / "in_offset").write_text("1.0\n")
    for i, ch in enumerate(("in_accel_x", "in_accel_y", "in_accel_z")):
        (scan / f"{ch}_en").write_text("1\n")
        (scan / f"{ch}_index").write_text(f"{i}\n")
        (scan / f"{ch}_type").write_text(f"{scan_type}\n")
        (d / f"{ch}_raw").write_text(f"{10 * (i + 1)}\n")
    # a disabled channel must be skipped
    (scan / "in_temp_en").write_text("0\n")
    (scan / "in_temp_index").write_text("9\n")
    (scan / "in_temp_type").write_text("le:s16/16>>0\n")
    return base


@pytest.mark.parametrize("props", [
    "device=fake_accel frequency=500 num-buffers=2",
    "device-number=0 frequency=500 raw=true num-buffers=1",
    "device=fake_accel frequency=500 mode=one-shot",
    "device=fake_accel frequency=500 channels=0,2 num-buffers=2",
    "device=fake_accel frequency=500 merge-channels-data=false num-buffers=1",
])
def test_polled_scans_match_the_reference(tmp_path, props):
    base = fake_iio(tmp_path)
    line = f"tensor_src_iio {props} base-dir={base} ! tensor_sink name=out"
    want = collect(jax_parse_launch, line)
    got = collect(parse_launch, line)
    assert got == want and got[0]


def test_polled_scan_values(tmp_path):
    base = fake_iio(tmp_path)
    got, _ = collect(parse_launch, f"tensor_src_iio device=fake_accel "
                     f"base-dir={base} frequency=500 num-buffers=1 ! "
                     "tensor_sink name=out")
    # (raw + offset) * scale with offset=1.0 scale=0.5
    assert got[0][0] == ("float32", (3,), np.array(
        [5.5, 10.5, 15.5], np.float32).tobytes())


@pytest.mark.parametrize("scan_type,raw_dtype", [
    ("le:s16/16>>0", np.int16), ("le:s16/32>>2", np.int32),
    ("be:u8/8>>0", np.uint8)])
def test_buffered_reads_match_the_reference(tmp_path, scan_type, raw_dtype):
    """The /dev node is a regular file of packed scans (a fake device):
    both packages decode the same values."""
    base = fake_iio(tmp_path, scan_type)
    dev = tmp_path / "dev"
    dev.mkdir()
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 100, (4, 3)).astype(raw_dtype)
    if scan_type.startswith("be"):
        vals = vals.astype(">u1")
    (dev / "iio:device0").write_bytes(vals.tobytes())
    line = (f"tensor_src_iio device=fake_accel base-dir={base} "
            f"dev-dir={dev} raw=true num-buffers=4 ! tensor_sink name=out")
    want = collect(jax_parse_launch, line)
    got = collect(parse_launch, line)
    assert got == want and len(got[0]) == 4


def test_missing_device_errors(tmp_path):
    pipe = parse_launch(f"tensor_src_iio device=ghost base-dir={tmp_path} "
                        "! tensor_sink name=out")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
    pipe.stop()
    assert msg is not None and "ghost" in msg.data["error"]


@pytest.mark.parametrize("type_str,raw", [
    ("le:s12/16>>4", b"\xf0\x7f"), ("le:s12/16>>4", b"\x00\x80"),
    ("be:u8/8>>0", b"\xff"), ("le:s16/32>>2", b"\xfc\xff\x00\x00"),
    ("le:u10/16X2>>0", b"\xff\x03")])
def test_type_string_parsing(type_str, raw):
    a, b = iio._Channel("x", 0, type_str), jiio._Channel("x", 0, type_str)
    assert a.decode(raw) == b.decode(raw)
    assert (a.bits, a.storage, a.shift, a.signed, a.le) == \
        (b.bits, b.storage, b.shift, b.signed, b.le)


def test_type_string_values():
    c = iio._Channel("x", 0, "le:s12/16>>4")
    assert c.decode(b"\xf0\x7f") == 2047
    assert c.decode(b"\x00\x80") == -2048
    assert iio._Channel("y", 1, "be:u8/8>>0").decode(b"\xff") == 255
    with pytest.raises(ValueError):
        iio._Channel("z", 2, "le:s16/24>>0")


def test_buffered_scan_layout_alignment():
    """3x s16 + s64 timestamp -> offsets 0,2,4,8; total 16, not 14."""
    el = iio.TensorSrcIIO()
    el._channels = [iio._Channel("x", 0, "le:s16/16>>0"),
                    iio._Channel("y", 1, "le:s16/16>>0"),
                    iio._Channel("z", 2, "le:s16/16>>0"),
                    iio._Channel("ts", 3, "le:s64/64>>0")]
    assert el._scan_layout() == ([0, 2, 4, 8], 16)
