"""tensor_filter's hot swap, suspend and property breadth: the port
against nnstreamer_tpu.

Both packages run the same lines — nnstreamer_tpu on JAX-CPU, the port
with ``accelerator=cpu`` — and are held to the same outputs, caps and
errors: ``reload_model`` and ``prepare_model``/``commit_model``/
``release_prepared`` (also on a fused segment, which re-captures at one
boundary), ``is-updatable=false``, ``suspend`` (the idle watchdog unloads,
the next buffer reopens), ``invoke-dynamic``, the layout and tensor-name
properties, and the fusion barriers they set. The card's side (the
fence behind the last replay, the freed bytes) is in
``tests/test_torch_streams_cuda.py``."""
import time

import numpy as np
import pytest

from nnstreamer_tpu.elements.filter import TensorFilter as JTensorFilter
from nnstreamer_tpu.runtime.element import ElementError as JElementError
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.runtime.element import ElementError
from nnstreamer_tpu_torch.runtime.parse import parse_launch

PORT = ("torch", "accelerator=cpu ", parse_launch, TensorFilter,
        ElementError)
REF = ("jax", "", jax_parse_launch, JTensorFilter, JElementError)
BOTH = [pytest.param(PORT, id="port"), pytest.param(REF, id="reference")]


@pytest.fixture(autouse=True)
def _tsan_clean():
    """Under NNS_TSAN=1: the swap, suspend and fused paths add no
    lock-order violation."""
    before = len(tsan.violations())
    yield
    assert tsan.violations()[before:] == []


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def _settle(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.01)
    return predicate()


def _reload_run(make, swap):
    fw, acc, parse, _, _ = make
    pipe = parse(
        "appsrc name=in caps=other/tensors,format=static,dimensions=2,"
        f"types=float32 ! tensor_filter framework={fw} {acc}"
        "model=builtin://scaler?factor=2 name=f ! tensor_sink name=out")
    src, sink, filt = pipe.get("in"), pipe.get("out"), pipe.get("f")
    pipe.play()
    src.push_buffer(np.ones(2, np.float32))
    b1 = sink.pull(timeout=10)
    swap(filt)
    src.push_buffer(np.ones(2, np.float32))
    b2 = sink.pull(timeout=10)
    src.end_of_stream()
    pipe.wait(timeout=10)
    pipe.stop()
    return _np(b1.tensors[0]).tolist(), _np(b2.tensors[0]).tolist(), filt


def test_reload_model_matches_the_reference():
    def swap(f):
        f.reload_model("builtin://scaler?factor=10")
    got = _reload_run(PORT, swap)
    want = _reload_run(REF, swap)
    assert got[:2] == want[:2] == ([2.0, 2.0], [10.0, 10.0])
    assert got[2].props["model"] == want[2].props["model"]
    # the old model went only after its fence (no card: nothing to wait on)
    assert [step for step, _ in got[2].swap_log] == ["no fence", "released"]


def test_staged_swap_matches_the_reference():
    def swap(f):
        prepared = f.prepare_model("builtin://scaler?factor=3")
        old = f.commit_model(prepared, "builtin://scaler?factor=3")
        assert old is not None and old is not prepared
        f.release_prepared(old)
        assert old.props is None  # closed
    got = _reload_run(PORT, swap)
    want = _reload_run(REF, swap)
    assert got[:2] == want[:2] == ([2.0, 2.0], [3.0, 3.0])
    assert [step for step, _ in got[2].swap_log] == ["no fence", "released"]


@pytest.mark.parametrize("make", BOTH)
def test_prepare_then_rollback_keeps_the_live_model(make):
    def swap(f):
        f.release_prepared(f.prepare_model("builtin://scaler?factor=7"))
    assert _reload_run(make, swap)[:2] == ([2.0, 2.0], [2.0, 2.0])


def test_is_updatable_false_refuses_like_the_reference():
    texts = []
    for _, _, _, cls, err in (PORT, REF):
        f = cls(framework="torch", model="builtin://scaler",
                is_updatable=False, name="f")
        with pytest.raises(err) as e1:
            f.reload_model("builtin://add")
        with pytest.raises(err) as e2:
            f.prepare_model("builtin://add")
        texts.append((str(e1.value), str(e2.value)))
    assert texts[0] == texts[1]
    assert texts[0] == (
        "tensor_filter:f: model reload refused (is-updatable=false)",
        "tensor_filter:f: model swap refused (is-updatable=false)")


def test_shared_key_swap_keeps_the_other_filter_alive():
    """A retired backend opened under a share key is released under it:
    the second filter on the key keeps it open (refcount), as in the
    reference's commit_model."""
    from nnstreamer_tpu_torch.backends import base

    line = ("tensor_src num-buffers=1 dimensions=2 types=float32 "
            "pattern=ones ! tee name=t "
            "t. ! queue ! tensor_filter framework=torch accelerator=cpu "
            "model=builtin://scaler?factor=2 shared-tensor-filter-key=sk "
            "name=f1 ! tensor_sink name=o1 "
            "t. ! queue ! tensor_filter framework=torch accelerator=cpu "
            "model=builtin://scaler?factor=2 shared-tensor-filter-key=sk "
            "name=f2 ! tensor_sink name=o2")
    pipe = parse_launch(line)
    pipe.play()
    pipe.wait(timeout=15)
    f1, f2 = pipe.get("f1"), pipe.get("f2")
    shared = f1.backend
    assert shared is f2.backend and base._shared["sk"].refcount == 2
    old = f1.commit_model(f1.prepare_model("builtin://scaler?factor=3"),
                          "builtin://scaler?factor=3")
    f1.release_prepared(old)
    assert old is shared and shared.props is not None  # still open
    assert base._shared["sk"].refcount == 1
    pipe.stop()
    assert "sk" not in base._shared and shared.props is None


def _commit_mid_stream(parse, fw, acc):
    pipe = parse(
        "tensor_src num-buffers=-1 framerate=300 dimensions=4 "
        "types=float32 pattern=counter ! tensor_transform mode=arithmetic "
        f"option=add:1 {acc}! tensor_filter framework={fw} {acc}"
        "model=builtin://scaler?factor=2 name=f "
        "! tensor_sink name=out max-stored=512")
    f, out = pipe.get("f"), pipe.get("out")
    pipe.play()
    try:
        assert _settle(lambda: out.buffer_count >= 5, 10)
        (seg,) = pipe.fused_segments
        assert seg.stats["dispatches"] >= 5
        prepared = f.prepare_model("builtin://scaler?factor=3")
        old = f.commit_model(prepared, "builtin://scaler?factor=3")
        f.release_prepared(old)
        n_at_swap = out.buffer_count
        assert _settle(lambda: out.buffer_count >= n_at_swap + 5, 10)
    finally:
        pipe.stop()
    factors = []
    for k in range(out.buffer_count):
        b = out.pull(timeout=0.2)
        if b is None:
            break
        v = float(_np(b.tensors[0])[0])
        expect2, expect3 = (k + 1) * 2.0, (k + 1) * 3.0
        assert v in (expect2, expect3), (k, v)
        factors.append(2 if v == expect2 else 3)
    return factors, seg.stats["retraces"], f


@pytest.mark.parametrize("make", BOTH)
def test_commit_model_invalidates_mid_stream(make):
    """The fused transform→filter segment: outputs flip from factor 2 to
    factor 3 at one boundary and never revert, and the segment re-resolves
    (one composed callable before the swap, one after)."""
    fw, acc, parse, _, _ = make
    factors, retraces, f = _commit_mid_stream(parse, fw, acc)
    assert 3 in factors and 2 in factors
    first3 = factors.index(3)
    assert all(x == 3 for x in factors[first3:])
    assert retraces >= 2
    if make is PORT:
        assert [step for step, _ in f.swap_log] == ["no fence", "released"]


def test_reload_on_a_fused_segment_recomposes_once():
    """reload_model on a fused filter: one composed build before, one
    after (retraces 2, as the card's captures), and the old model's
    callable is let go only after the fence."""
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=4,"
        "types=float32 ! tensor_transform mode=arithmetic option=add:1 "
        "accelerator=cpu ! tensor_filter framework=torch accelerator=cpu "
        "model=builtin://scaler?factor=2 name=f ! tensor_sink name=out")
    src, out, f = pipe.get("in"), pipe.get("out"), pipe.get("f")
    pipe.play()
    for _ in range(3):
        src.push_buffer(np.ones(4, np.float32))
    before = [float(out.pull(timeout=10).tensors[0][0]) for _ in range(3)]
    retired = f.backend._retired
    f.reload_model("builtin://scaler?factor=5")
    assert f.backend._retired == [] and retired is not f.backend._retired
    for _ in range(3):
        src.push_buffer(np.ones(4, np.float32))
    after = [float(out.pull(timeout=10).tensors[0][0]) for _ in range(3)]
    src.end_of_stream()
    pipe.wait(timeout=10)
    (seg,) = pipe.fused_segments
    pipe.stop()
    assert before == [4.0] * 3 and after == [10.0] * 3
    assert seg.stats["retraces"] == 2 and seg.stats["dispatches"] == 6


def _suspend_run(make, gap_s=0.6):
    fw, acc, parse, _, _ = make
    pipe = parse(
        "appsrc name=in caps=other/tensors,format=static,dimensions=4,"
        f"types=float32 ! tensor_filter framework={fw} {acc}"
        "model=builtin://scaler?factor=2 suspend=120 name=f "
        "! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    f, src = pipe.get("f"), pipe.get("in")
    src.push_buffer(np.ones(4, np.float32))
    assert _settle(lambda: len(got) == 1)
    assert _settle(lambda: f.backend is None, 5), "not suspended while idle"
    src.push_buffer(np.full(4, 3.0, np.float32))
    assert _settle(lambda: len(got) == 2)
    reopened = f.backend is not None
    src.end_of_stream()
    pipe.wait(timeout=10)
    pipe.stop()
    return [_np(b.tensors[0]).tolist() for b in got], reopened, f


def test_suspend_unloads_and_resumes_like_the_reference():
    got, reopened, f = _suspend_run(PORT)
    want, jreopened, _ = _suspend_run(REF)
    assert got == want == [[2.0] * 4, [6.0] * 4]
    assert reopened and jreopened
    assert [step for step, _ in f.swap_log][:2] == ["no fence", "released"]


def test_suspend_set_on_a_running_fused_filter_defuses_and_unloads():
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=4,"
        "types=float32 ! tensor_transform mode=arithmetic option=add:1 "
        "accelerator=cpu ! tensor_filter framework=torch accelerator=cpu "
        "model=builtin://scaler?factor=2 name=f ! tensor_sink name=out")
    src, out, f = pipe.get("in"), pipe.get("out"), pipe.get("f")
    pipe.play()
    try:
        src.push_buffer(np.ones(4, np.float32))
        assert float(out.pull(timeout=10).tensors[0][0]) == 4.0
        (seg,) = pipe.fused_segments
        assert seg.stats["dispatches"] == 1
        f.set_property("suspend", 100)
        assert f.fusion_barrier().startswith("suspend")
        assert _settle(lambda: f.backend is None, 5)
        src.push_buffer(np.ones(4, np.float32))
        assert float(out.pull(timeout=10).tensors[0][0]) == 4.0
        assert seg.stats["defused"] == 1 and seg.stats["dispatches"] == 1
    finally:
        pipe.stop()


@pytest.mark.parametrize("make", BOTH)
def test_invoke_dynamic_flexible_caps(make):
    fw, acc, parse, _, _ = make
    pipe = parse(
        "tensor_src num-buffers=2 dimensions=4 types=float32 "
        f"! tensor_filter framework={fw} {acc}model=builtin://argmax "
        "invoke-dynamic=true name=f ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.run(timeout=30)
    assert "flexible" in str(pipe.get("out").sinkpad.caps)
    assert len(got) == 2
    assert pipe.get("f").fusion_barrier().startswith("invoke-dynamic")


def test_barriers_and_caps_match_the_reference():
    for props in ("invoke-dynamic=true", "suspend=50", "sync-invoke=true",
                  "latency-report=true", ""):
        results = []
        for fw, acc, parse, _, _ in (PORT, REF):
            pipe = parse(
                "tensor_src num-buffers=2 dimensions=4 types=float32 ! "
                f"tensor_transform mode=arithmetic option=add:1 {acc}! "
                f"tensor_filter framework={fw} {acc}"
                f"model=builtin://scaler?factor=2 {props} name=f ! "
                "tensor_sink name=out")
            pipe.run(timeout=30)
            results.append((pipe.get("f").fusion_barrier(),
                            str(pipe.get("out").sinkpad.caps),
                            len(pipe.fused_segments)))
        assert results[0] == results[1], props


@pytest.mark.parametrize("make", BOTH)
def test_layout_and_name_properties(make):
    fw, _, _, cls, err = make
    f = cls(framework=fw, model="builtin://scaler", inputlayout="NHWC,any",
            outputlayout="nchw", inputname="a,b", outputname="out")
    assert f.props["inputlayout"] == "NHWC,any"
    assert f.props["outputlayout"] == "nchw"
    assert (f.props["inputname"], f.props["outputname"]) == ("a,b", "out")
    with pytest.raises(ValueError, match="not one of any|NHWC|NCHW|none"):
        cls(framework=fw, model="builtin://scaler", inputlayout="NWHC")


def test_layout_error_text_matches_the_reference():
    texts = []
    for _, _, _, cls, _ in (PORT, REF):
        with pytest.raises(ValueError) as ei:
            cls(framework="x", model="builtin://scaler",
                outputlayout="NHWC,CHW")
        texts.append(str(ei.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("make", BOTH)
def test_forced_output_dims(make):
    fw, _, _, cls, _ = make
    f = cls(framework=fw, model="noop", output_dims="4",
            output_types="float32")
    forced = f._forced_info(f.props["output_dims"], f.props["output_types"])
    assert forced.specs[0].shape == (4,)


@pytest.mark.parametrize("make", BOTH)
def test_config_file_merges_custom(tmp_path, make):
    fw, _, _, cls, _ = make
    cfg = tmp_path / "f.conf"
    cfg.write_text("# comment\nfactor:5\nsuspend=20\n")
    f = cls(framework=fw, model="builtin://scaler", custom="device:0",
            config_file=str(cfg))
    assert f._custom_with_config_file() == "device:0,factor:5"
    assert f.props["suspend"] == 20.0


@pytest.mark.parametrize("make", BOTH)
def test_readonly_latency_throughput_props(make):
    fw, acc, parse, _, _ = make
    pipe = parse(
        "tensor_src num-buffers=8 dimensions=4 types=float32 "
        f"! tensor_filter framework={fw} {acc}model=builtin://scaler?factor=2 "
        "sync-invoke=true name=f ! tensor_sink name=out")
    pipe.run(timeout=30)
    f = pipe.get("f")
    assert f.get_property("latency") > 0
    assert f.get_property("throughput") > 0


def test_torch_backend_serves_declared_model_info():
    """After SET_INPUT_INFO the torch backend serves the model info (as
    nnstreamer_tpu's jax backend does after eval_shape), and a reload
    keeps it."""
    from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                    BackendEvent,
                                                    FilterProperties)
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
    from nnstreamer_tpu_torch.core import TensorsInfo
    from nnstreamer_tpu_torch.core.tensors import TensorSpec

    b = TorchBackend()
    b.open(FilterProperties(model="builtin://scaler?factor=2",
                            accelerator=Accelerator.CPU))
    assert b.get_model_info() == (None, None)
    info = TensorsInfo.of(TensorSpec((3, 4), "float32"))
    out = b.set_input_info(info)
    assert b.get_model_info() == (info, out)
    b.handle_event(BackendEvent.RELOAD_MODEL)
    assert len(b._retired) == 1 and b.get_model_info() == (info, out)
    b.release_retired()
    assert b._retired == []
    b.close()
    assert b.get_model_info() == (None, None)
