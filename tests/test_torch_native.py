"""The port's native host runtime (``nnstreamer_tpu_torch/native``: the
buffer pool, the ring, the repo prefetcher, gather/scatter and the q8
int8 engine) against nnstreamer_tpu's on the same inputs: the cases of
``test_native.py`` and ``test_q8_native.py``, run through both packages,
with the same results required. The C++ sources are the same files; the
port builds them into ``build/native/``."""
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu import native as ref_native
from nnstreamer_tpu.native import q8 as ref_q8
from nnstreamer_tpu_torch import native
from nnstreamer_tpu_torch.native import _build, q8

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "fixtures" / "tiny_int8_perchannel.tflite")
PKGS = {"ref": ref_native, "port": native}

pytestmark = pytest.mark.skipif(
    not (native.available() and q8.available()),
    reason="native runtime not buildable here")


def test_sources_are_the_reference_and_build_outside_the_package():
    for name in ("nns_core.cc", "nns_q8.cc"):
        assert (ROOT / "nnstreamer_tpu_torch/native/csrc" / name
                ).read_bytes() == (ROOT / "nnstreamer_tpu/native/csrc"
                                   / name).read_bytes()
    for name in ("nns_core", "nns_q8"):
        lib = _build.library_path(_build.CSRC / f"{name}.cc",
                                  ("-lpthread",) if name == "nns_core"
                                  else ())
        assert lib.exists() and lib.parent == ROOT / "build" / "native"
    assert not list((ROOT / "nnstreamer_tpu_torch").rglob("*.so"))


def test_kill_switch_disables_both(monkeypatch):
    monkeypatch.setenv("NNS_DISABLE_NATIVE", "1")
    assert not native.available() and not q8.available()
    assert ref_native.available() is native.available()


def _pool_trace(mod):
    pool = mod.BufferPool(4096, alignment=64)
    a, b = pool.acquire(), pool.acquire()
    aligned = a % 64 == 0 and b % 64 == 0 and a != b
    pool.release(a)
    c = pool.acquire()
    stats = pool.stats()
    pool.close()
    small = mod.BufferPool(128, max_blocks=2)
    x, y = small.acquire(), small.acquire()
    bounded = small.acquire() is None
    small.release(x)
    again = small.acquire() == x
    small.close()
    return aligned, c == a, stats, bool(x and y), bounded, again


def test_pool_matches_reference():
    got = _pool_trace(native)
    assert got == _pool_trace(ref_native)
    assert got == (True, True, {"acquires": 3, "reuses": 1}, True, True,
                   True)


def _ring_trace(mod):
    ring = mod.Ring(capacity=4)
    pushed = [ring.push(0x1000 + i, 10 * i, tag=i) for i in range(4)]
    got = [ring.pop() for _ in range(4)]
    empty = ring.pop(timeout_ms=10)
    ring.close_ring()
    with pytest.raises(EOFError):
        ring.pop()
    ring.destroy()
    return pushed, got, empty


def test_ring_matches_reference():
    got = _ring_trace(native)
    assert got == _ring_trace(ref_native)
    assert got[1][3] == (0x1003, 30, 3)


def test_ring_backpressure_blocks_producer():
    ring = native.Ring(capacity=2)
    assert ring.push(1, 0) and ring.push(2, 0)
    assert not ring.push(3, 0, timeout_ms=20)  # full -> timeout
    popped = []
    t = threading.Thread(target=lambda: popped.append(ring.pop()))
    t.start()
    assert ring.push(3, 0, timeout_ms=2000)  # unblocked by the pop
    t.join()
    assert popped[0][0] == 1
    ring.destroy()


def test_gather_scatter_matches_reference():
    parts = [np.arange(10, dtype=np.float32), np.arange(7, dtype=np.uint8),
             np.arange(4, dtype=np.int64).reshape(2, 2)]
    raw = [np.frombuffer(p.tobytes(), np.uint8) for p in parts]
    flat = native.gather(raw)
    np.testing.assert_array_equal(flat, ref_native.gather(raw))
    outs = [np.empty_like(p) for p in parts]
    native.scatter(flat, outs)
    for p, o in zip(parts, outs):
        np.testing.assert_array_equal(p, o)


def _read_all(mod, path, sample, order):
    reader = mod.RepoReader(str(path), sample, order, prefetch_depth=3)
    seen = []
    try:
        while True:
            try:
                view, idx, block = reader.next()
            except StopIteration:
                break
            seen.append((idx, view.tobytes()))
            reader.release(block)
    finally:
        reader.close()
    return seen


def test_repo_reader_matches_reference(tmp_path):
    sample, n = 32, 10
    data = np.arange(n * sample, dtype=np.uint8)
    path = tmp_path / "samples.dat"
    path.write_bytes(data.tobytes())
    order = [3, 1, 4, 1, 5, 9, 2, 6]
    got = _read_all(native, path, sample, order)
    assert got == _read_all(ref_native, path, sample, order)
    assert [i for i, _ in got] == order
    assert got[0][1] == data[3 * sample:4 * sample].tobytes()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_repo_reader_read_error(tmp_path, pkg):
    path = tmp_path / "short.dat"
    path.write_bytes(b"\x00" * 16)  # one half-sample
    reader = PKGS[pkg].RepoReader(str(path), 32, [0], prefetch_depth=2)
    with pytest.raises(OSError):
        while True:
            _, _, block = reader.next()
            reader.release(block)
    reader.close()


def _write_repo(tmp_path, n_samples=12):
    from nnstreamer_tpu_torch.core import TensorsInfo, caps_from_tensors_info
    from nnstreamer_tpu_torch.core.tensors import DataType, TensorSpec
    import json

    info = TensorsInfo.of(TensorSpec((2, 3), DataType.FLOAT32))
    rng = np.random.default_rng(7)
    samples = rng.standard_normal((n_samples, 2, 3)).astype(np.float32)
    loc = tmp_path / "d.dat"
    loc.write_bytes(samples.tobytes())
    jpath = tmp_path / "d.json"
    jpath.write_text(json.dumps({
        "gst_caps": str(caps_from_tensors_info(info)),
        "total_samples": n_samples, "sample_size": info.nbytes}))
    return loc, jpath


def _repo_stream(parse_launch, loc, jpath, shuffle, use_native, runs=1):
    got = []
    pipe = parse_launch(
        f"datareposrc location={loc} json={jpath} epochs=2 "
        f"is-shuffle={str(shuffle).lower()} seed=5 "
        f"use-native={str(use_native).lower()} name=src ! tensor_sink "
        "name=out")
    used = []
    pipe.get("out").connect(lambda b: (
        used.append(getattr(pipe.get("src"), "_native_reader") is not None),
        got.append((b.offset, np.asarray(b.tensors[0]).tobytes()))))
    for _ in range(runs):
        pipe.run(timeout=30.0)
    return got, used


@pytest.mark.parametrize("shuffle", [False, True])
def test_datareposrc_native_matches_python_and_reference(tmp_path, shuffle):
    from nnstreamer_tpu.runtime.parse import parse_launch as ref_parse
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    loc, jpath = _write_repo(tmp_path)
    nat, used = _repo_stream(parse_launch, loc, jpath, shuffle, True)
    py, unused = _repo_stream(parse_launch, loc, jpath, shuffle, False)
    ref, _ = _repo_stream(ref_parse, loc, jpath, shuffle, True)
    assert all(used) and not any(unused)
    assert nat == py == ref and len(nat) == 24


@pytest.mark.parametrize("use_native", [False, True])
def test_datareposrc_replay_is_deterministic(tmp_path, use_native):
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    loc, jpath = _write_repo(tmp_path, n_samples=8)
    got, _ = _repo_stream(parse_launch, loc, jpath, True, use_native, runs=2)
    assert len(got) == 32 and got[:16] == got[16:]


def _conv_program(mod):
    rng = np.random.default_rng(7)
    n, h, w, c, oc, kh, stride = 2, 9, 9, 8, 5, 3, 2
    x = rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    w8 = rng.integers(-127, 128, (oc, kh, kh, c), dtype=np.int8)
    bias = rng.integers(-2000, 2000, oc).astype(np.int32)
    wzp = rng.integers(-3, 4, oc).astype(np.int32)  # per-channel, nonzero
    mult = (rng.random(oc) * 0.002 + 0.0005).astype(np.float32)
    oh = ow = (h + 2 - kh) // stride + 1
    prog = mod.Q8Program(2)
    prog.buf(0, n * h * w * c)
    prog.buf(1, n * oh * ow * oc)
    wkn = np.ascontiguousarray(
        w8.transpose(1, 2, 3, 0).reshape(kh * kh * c, oc))
    prog.add_conv(0, 1, n, h, w, c, oh, ow, oc, kh, kh, stride, stride,
                  1, 1, wkn, wzp, bias, mult, 131, 7, 0, 255)
    prog.io([0], [1])
    out = np.empty(n * oh * ow * oc, np.uint8)
    prog.run([x.reshape(-1)], [out])
    # integer oracle: stored u8 activations, s8 weights, f32 requant,
    # round half to even
    xp = np.full((n, h + 2, w + 2, c), 131, np.int32)
    xp[:, 1:1 + h, 1:1 + w] = x
    want = np.empty((n, oh, ow, oc), np.uint8)
    for i in range(n):
        for y in range(oh):
            for x0 in range(ow):
                patch = xp[i, y * stride:y * stride + kh,
                           x0 * stride:x0 * stride + kh]
                for o in range(oc):
                    acc = int(np.sum((patch - 131)
                                     * (w8[o].astype(np.int32) - wzp[o])))
                    v = int(np.rint(np.float32(acc + bias[o])
                                    * np.float32(mult[o]))) + 7
                    want[i, y, x0, o] = np.clip(v, 0, 255)
    return out, want


def test_q8_conv_matches_reference_engine_and_oracle():
    got, want = _conv_program(q8)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(got, _conv_program(ref_q8)[0])


def _chain_program(mod):
    rng = np.random.default_rng(3)
    h = w = 8
    c = 16
    x = rng.integers(0, 256, (1, h, w, c), dtype=np.uint8)
    dw_w = rng.integers(-80, 80, (3 * 3, c), dtype=np.int8)
    bias = rng.integers(-500, 500, c).astype(np.int32)
    prog = mod.Q8Program(5)
    for i, size in enumerate((h * w * c,) * 3 + (c, c)):
        prog.buf(i, size)
    prog.add_dw(0, 1, 1, h, w, c, h, w, 3, 3, 1, 1, 1, 1, dw_w,
                np.zeros(c, np.int32), bias, np.full(c, 0.002, np.float32),
                128, 128, 10, 250)
    prog.add_add(0, 1, 2, h * w * c, np.float32(0.5), np.float32(0.5),
                 np.float32(0.0), 0, 255)
    prog.add_avgpool(2, 3, 1, h, w, c, 1, 1, h, w, 1, 1, 0, 0,
                     128, np.float32(1.0), 128, 0, 255)
    prog.add_softmax(3, 4, 1, c, np.float32(0.1), 128,
                     np.float32(256.0), 0, np.float32(1.0))
    prog.io([0], [1, 4])
    out1, out = np.empty(h * w * c, np.uint8), np.empty(c, np.uint8)
    prog.run([x.reshape(-1)], [out1, out])
    return out1, out


def test_q8_dw_add_avgpool_softmax_matches_reference():
    out1, out = _chain_program(q8)
    ref1, ref = _chain_program(ref_q8)
    np.testing.assert_array_equal(out1, ref1)
    np.testing.assert_array_equal(out, ref)
    assert 250 <= int(out.sum()) <= 262
    assert out1.min() >= 10 and out1.max() <= 250


def test_q8_simd_level_matches_reference():
    assert q8.simd_level() == ref_q8.simd_level() in (0, 1)


@pytest.mark.parametrize("float_output", [False, True])
def test_native_fixture_conversions_match_reference(float_output):
    from nnstreamer_tpu.models.tflite_import import load_tflite as ref_load
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    opts = {"quantized_exec": "int8-native", "batch": "3"}
    if float_output:
        opts["float_output"] = "1"
    rng = np.random.default_rng(9)
    x8 = rng.integers(-128, 128, (3, 16, 16, 3), dtype=np.int8)
    fn, _, out_info = load_tflite(FIXTURE, opts)
    rfn, _, rout = ref_load(FIXTURE, opts)
    assert fn.host_native and fn.q8_simd == q8.simd_level()
    assert out_info.specs[0].dtype.value == rout.specs[0].dtype.value
    # numpy, a CPU tensor and a float feed all give the reference's bytes
    want = rfn(x8)[0]
    for feed in (x8, torch.from_numpy(x8)):
        np.testing.assert_array_equal(fn(feed)[0], want)
    s, zp = 0.5, 3
    xf = ((x8.astype(np.float32) - zp) * s)
    np.testing.assert_array_equal(fn(xf)[0], rfn(xf)[0])


def test_native_wrong_sized_input_rejected_as_reference():
    from nnstreamer_tpu.models.tflite_import import load_tflite as ref_load
    from nnstreamer_tpu_torch.models.tflite_import import load_tflite

    one = np.zeros((1, 16, 16, 3), np.int8)
    opts = {"quantized_exec": "int8-native", "batch": "2"}
    msgs = []
    for load in (load_tflite, ref_load):
        with pytest.raises(ValueError, match="elements") as e:
            load(FIXTURE, opts)[0](one)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
