"""File sources and sinks (filesrc, multifilesrc, imagedec/pngdec/pnmdec,
fakesink, filesink, multifilesink) and the reference launch lines that
use them: the port against nnstreamer_tpu.

Each line runs through both packages and the outputs are compared
exactly: the buffers at the sinks as (dtype, shape, raw bytes), the bytes
the file sinks wrote, and the error texts of refused lines."""
import io

import numpy as np
import pytest
from test_reference_launch_compat import REFERENCE_LINES

from nnstreamer_tpu.core import MessageType as JMessageType
from nnstreamer_tpu.runtime.element import ElementError as JElementError
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.runtime.element import ElementError
from nnstreamer_tpu_torch.runtime.parse import parse_launch

BOTH = ((parse_launch, MessageType, ElementError),
        (jax_parse_launch, JMessageType, JElementError))


def _rec(t):
    if hasattr(t, "numpy") and not isinstance(t, np.ndarray):
        t = t.numpy()
    a = np.ascontiguousarray(np.asarray(t))
    return (a.dtype.name, a.shape, a.tobytes())


def collect_both(line, timeout=20.0):
    """Buffers at ``out`` as records, from the port and the reference."""
    out = []
    for parse, _, _ in BOTH:
        pipe = parse(line)
        got = []
        pipe.get("out").connect(
            lambda b, _g=got: _g.append(tuple(_rec(t) for t in b.tensors)))
        pipe.run(timeout=timeout)
        out.append(got)
    assert out[0] == out[1]
    return out[0]


def error_both(line):
    texts = []
    for parse, mt, _ in BOTH:
        pipe = parse(line)
        pipe.play()
        msg = pipe.bus.wait_for((mt.ERROR,), timeout=5)
        pipe.stop()
        assert msg is not None
        texts.append(msg.data["error"].split(": ", 1)[-1])
    assert texts[0] == texts[1]
    return texts[0]


def construct_error_both(line, match):
    texts = []
    for parse, _, err in BOTH:
        with pytest.raises(err, match=match) as ei:
            parse(line)
        texts.append(str(ei.value).split(": ", 1)[-1])
    assert texts[0] == texts[1]


class TestFileSources:
    def test_filesrc_whole_file(self, tmp_path):
        data = np.arange(12, dtype=np.float32)
        p = tmp_path / "x.raw"
        p.write_bytes(data.tobytes())
        got = collect_both(
            f"filesrc location={p} "
            "! tensor_converter input-dim=12 input-type=float32 "
            "! tensor_sink name=out")
        assert len(got) == 1 and got[0][0][2] == data.tobytes()

    def test_filesrc_blocksize_chunks(self, tmp_path):
        p = tmp_path / "x.bin"
        p.write_bytes(bytes(range(10)))
        got = collect_both(
            f"filesrc location={p} blocksize=4 ! tensor_sink name=out")
        assert [r[0][1] for r in got] == [(4,), (4,), (2,)]

    def test_multifilesrc_range_and_order(self, tmp_path):
        for i in range(4):
            (tmp_path / f"f.{i}").write_bytes(np.full(3, i, np.uint8).tobytes())
        got = collect_both(
            f"multifilesrc location={tmp_path}/f.%d start-index=1 stop-index=3 "
            "! tensor_converter input-dim=3 input-type=uint8 "
            "! tensor_sink name=out")
        assert [r[0][2][0] for r in got] == [1, 2, 3]

    def test_multifilesrc_open_ended_stops_at_gap(self, tmp_path):
        for i in range(2):
            (tmp_path / f"g.{i}").write_bytes(b"ab")
        got = collect_both(
            f"multifilesrc location={tmp_path}/g.%d ! tensor_sink name=out")
        assert len(got) == 2

    def test_multifilesrc_missing_before_stop_errors(self, tmp_path):
        (tmp_path / "h.0").write_bytes(b"x")
        text = error_both(f"multifilesrc name=src location={tmp_path}/h.%d "
                          "stop-index=3 ! tensor_sink name=out")
        assert "missing" in text

    def test_filesrc_blocksize_zero_rejected(self, tmp_path):
        p = tmp_path / "z.bin"
        p.write_bytes(b"x")
        construct_error_both(
            f"filesrc name=src location={p} blocksize=0 ! tensor_sink name=out",
            "blocksize")

    def test_filesrc_location_required(self):
        construct_error_both("filesrc name=src ! tensor_sink name=out",
                             "location")

    def test_multifilesrc_literal_needs_stop_index(self, tmp_path):
        p = tmp_path / "fixed.raw"
        p.write_bytes(b"abc")
        construct_error_both(
            f"multifilesrc name=src location={p} ! tensor_sink name=out",
            "no %d")
        got = collect_both(
            f"multifilesrc location={p} stop-index=2 ! tensor_sink name=out")
        assert len(got) == 3

    def test_multifilesrc_double_percent_pattern_rejected(self, tmp_path):
        construct_error_both(
            f"multifilesrc name=src location={tmp_path}/f_%d_%d.raw "
            "stop-index=1 "
            "! tensor_sink name=out", "exactly one")

    def test_filesrc_caps_override_links_typed_downstream(self, tmp_path):
        data = np.arange(6, dtype=np.float32)
        p = tmp_path / "t.raw"
        p.write_bytes(data.tobytes())
        got = collect_both(
            f"filesrc location={p} caps=application/octet-stream "
            "! tensor_converter input-dim=6 input-type=float32 "
            "! tensor_sink name=out")
        assert len(got) == 1


class TestImageDec:
    @pytest.fixture(autouse=True)
    def _pil(self):
        pytest.importorskip("PIL")

    @staticmethod
    def _png(rgb):
        from PIL import Image

        b = io.BytesIO()
        Image.fromarray(rgb).save(b, "PNG")
        return b.getvalue()

    @pytest.mark.parametrize("dec", ["imagedec", "pngdec", "pnmdec"])
    def test_png_roundtrip(self, tmp_path, dec):
        rgb = np.random.default_rng(5).integers(0, 255, (7, 9, 3)).astype(np.uint8)
        p = tmp_path / "img.png"
        p.write_bytes(self._png(rgb))
        got = collect_both(f"filesrc location={p} ! {dec} ! tensor_sink name=out")
        assert got[0][0][2] == rgb.tobytes()

    def test_chunked_concatenated_pngs(self, tmp_path):
        frames = [np.random.default_rng(i).integers(0, 255, (6, 8, 3))
                  .astype(np.uint8) for i in range(3)]
        p = tmp_path / "strip.bin"
        p.write_bytes(b"".join(self._png(f) for f in frames))
        got = collect_both(
            f"filesrc location={p} blocksize=100 ! imagedec ! tensor_sink name=out")
        assert [r[0][2] for r in got] == [f.tobytes() for f in frames]

    def test_pgm_through_typed_caps(self, tmp_path):
        gray = np.arange(12, dtype=np.uint8).reshape(3, 4)
        p = tmp_path / "g.pgm"
        p.write_bytes(b"P5\n4 3\n255\n" + gray.tobytes())
        got = collect_both(
            f"filesrc location={p} ! image/x-portable-graymap ! pnmdec "
            "! tensor_sink name=out")
        assert got[0][0][1] == (3, 4, 3)

    def test_undecodable_tail_errors(self, tmp_path):
        p = tmp_path / "bad.png"
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 20)
        text = error_both(f"filesrc location={p} ! imagedec name=dec ! "
                          "tensor_sink name=out")
        assert "undecodable" in text


def test_imagedec_without_pillow_raises_the_reference_error(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    texts = []
    for parse, _, err in BOTH:
        with pytest.raises(err, match="Pillow is required") as ei:
            parse("filesrc location=/dev/null ! imagedec name=dec ! fakesink")
        texts.append(str(ei.value).split(": ", 1)[-1])
    assert texts[0] == texts[1]


class TestSinks:
    LINE = ("tensor_src num-buffers=3 dimensions=4:2 types={t} "
            "pattern=counter ! {sink}")

    @pytest.mark.parametrize("types", ["float32", "uint8", "int64"])
    def test_filesink_bytes(self, tmp_path, types):
        written = []
        for i, (parse, _, _) in enumerate(BOTH):
            out = tmp_path / f"o{i}.raw"
            parse(self.LINE.format(
                t=types, sink=f"filesink location={out} sync=true "
                "async=false buffer-mode=default")).run(timeout=10)
            written.append(out.read_bytes())
        assert written[0] == written[1]
        assert len(written[0]) == 3 * 8 * np.dtype(types).itemsize

    def test_multifilesink_files(self, tmp_path):
        files = []
        for i, (parse, _, _) in enumerate(BOTH):
            parse(self.LINE.format(
                t="int16", sink=f"multifilesink location={tmp_path}/r{i}/"
                "f_%02d.raw")).run(timeout=10)
            files.append(sorted((p.name, p.read_bytes())
                                for p in (tmp_path / f"r{i}").iterdir()))
        assert files[0] == files[1]
        assert [n for n, _ in files[0]] == ["f_00.raw", "f_01.raw", "f_02.raw"]

    def test_filesink_needs_location(self):
        texts = []
        for parse, mt, _ in BOTH:
            pipe = parse(self.LINE.format(t="uint8", sink="filesink"))
            with pytest.raises(Exception) as ei:
                pipe.run(timeout=5)
            texts.append(str(ei.value).rsplit(": ", 1)[-1])
        assert texts[0] == texts[1] == "location not set"

    def test_fakesink_counts(self):
        counts = []
        for parse, _, _ in BOTH:
            pipe = parse(self.LINE.format(t="float32",
                                          sink="fakesink name=out"))
            pipe.run(timeout=10)
            counts.append(pipe.get("out").buffer_count)
        assert counts == [3, 3]


@pytest.mark.parametrize("line", REFERENCE_LINES,
                         ids=[f"line{i}" for i in range(len(REFERENCE_LINES))])
def test_reference_line_parses_and_constructs_in_the_port(line):
    pipe = parse_launch(line)
    ref = jax_parse_launch(line)
    assert sorted(type(e).ELEMENT_NAME for e in pipe.elements.values()) == \
        sorted(type(e).ELEMENT_NAME for e in ref.elements.values())


def test_filesrc_num_buffers_and_sink_sync(tmp_path):
    data = tmp_path / "d.dat"
    data.write_bytes(bytes(range(16)))
    outs = []
    for i, (parse, _, _) in enumerate(BOTH):
        out = tmp_path / f"o{i}.dat"
        pipe = parse(
            f"filesrc location={data} blocksize=4 num_buffers=2 ! "
            "application/octet-stream ! "
            "tensor_converter input-dim=4:1 input-type=uint8 ! "
            f"filesink location={out} sync=true")
        pipe.play()
        pipe.wait(timeout=30)
        pipe.stop()
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == bytes(range(8))


def test_multifilesrc_literal_with_num_buffers(tmp_path):
    data = tmp_path / "t.dat"
    data.write_bytes(b"\x01\x02\x03\x04")
    got = collect_both(
        f"multifilesrc location={data} blocksize=-1 num_buffers=2 ! "
        "application/octet-stream ! "
        "tensor_converter input-dim=4:1 input-type=uint8 ! "
        "tensor_sink name=out max-stored=8")
    assert len(got) == 2


def test_repo_rnn_reference_line_runs_like_the_reference():
    """The reference's repo feedback line (mux of a source and a reposrc
    primed with initial-dummy, teed into a reposink): the same frames
    reach the sink in both packages."""
    from nnstreamer_tpu.elements.repo import REPO as JREPO
    from nnstreamer_tpu_torch.elements.repo import REPO

    line = (REFERENCE_LINES[5].replace("t. ! queue ! tensor_sink ",
                                       "t. ! queue ! tensor_sink name=out ")
            .replace("tensor_reposrc slot-index=41 ",
                     "tensor_reposrc slot-index=41 timeout=0.5 "))
    got = []
    for (parse, _, _), repo in zip(BOTH, (REPO, JREPO)):
        repo.reset()
        pipe = parse(line)
        recs = []
        pipe.get("out").connect(
            lambda b, _r=recs: _r.append(tuple(_rec(t) for t in b.tensors)))
        pipe.play()
        pipe.wait(timeout=20)
        pipe.stop()
        got.append(recs)
    assert got[0] == got[1]
    assert len(got[0]) == 2 and len(got[0][0]) == 2
