"""The memory accountant (obs/memory.py): the port against
nnstreamer_tpu.

Stage estimates merge by per-field maximum in both packages; a filter
stage records its model's param footprint under the profiler's series
name (the LM filter's equals ``tree_nbytes`` of its parameters, as in the
reference); queue occupancy bytes, the artifact ``memory`` section and
the MEMORY text of ``obs top`` are the reference's. The first-invoke
byte channels are measured on the card only (the reference reads XLA's
static analysis), so on the CPU the torch backend reports none; the
card's record is checked in tests/test_torch_obs_cuda.py."""
import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.caps import parse_caps_string as jparse_caps
from nnstreamer_tpu.obs import memory as jmemory
from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.core.caps import parse_caps_string
from nnstreamer_tpu_torch.models import lm_serving
from nnstreamer_tpu_torch.obs import flight as tflight
from nnstreamer_tpu_torch.obs import memory as tmemory
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.runtime.parse import parse_launch

LM = ("appsrc name=in caps=other/tensors,format=static,dimensions=6:4,"
      "types=int32 ! tensor_filter name=f framework={fw} {acc}"
      "model={pkg}.models.lm_serving:tiny ! tensor_sink name=out")
QLINE = ("tensor_src name=src num-buffers={n} dimensions=8 types=float32 "
         "! queue name=q0 max-size-buffers=4 ! tensor_sink name=out")


@pytest.fixture(autouse=True)
def _clean_memory_plane():
    before = len(tsan.violations())
    for mod in (tmemory, jmemory):
        mod.stop()
        mod.reset()
        mod.set_budget(None)
    yield
    for mod in (tmemory, jmemory):
        mod.stop()
        mod.reset()
        mod.set_budget(None)
    assert tsan.violations()[before:] == []


def oom_model(*xs):
    """A served model that runs the card out of memory (the filter's
    OOM path)."""
    raise torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


RECORDS = [("p:a..b", "fused", {"temp_bytes": 100, "param_bytes": 10}),
           ("p:a..b", "fused", {"temp_bytes": 40, "param_bytes": 70}),
           ("p:f", "filter", {"param_bytes": 5, "output_bytes": 9}),
           ("q:g", "filter", {"argument_bytes": 3})]


def test_accountant_max_watermark_matches():
    def run(mod):
        acc = mod.MemoryAccountant()
        for name, kind, fields in RECORDS:
            acc.record_stage(name, kind, **fields)
        acc.record_model("m", 5)
        acc.record_model("m", 3)
        return acc.stages(), acc.stages("p:"), acc.models(), acc.stage("zz")

    got, want = run(tmemory), run(jmemory)
    assert got == want
    assert got[0]["p:a..b"]["total_bytes"] == 170
    assert tmemory.FIELDS == jmemory.FIELDS


def test_disabled_accounting_records_nothing():
    assert not tmemory.ACTIVE
    _run_lm()
    assert tmemory.accountant().stages() == {}


def _run_lm(parse=parse_launch, line=None, feed=None):
    pipe = parse(line or LM.format(acc="accelerator=cpu ", fw="torch",
                                   pkg="nnstreamer_tpu_torch"))
    pipe.play()
    src = pipe.get("in")
    src.push_buffer(np.arange(24, dtype=np.int32).reshape(4, 6) % 50
                    if feed is None else feed)
    src.end_of_stream()
    msg = pipe.wait(timeout=120)
    pipe.stop()
    return pipe, msg


def test_lm_filter_param_bytes_match_the_reference():
    tmemory.start()
    _run_lm()
    got = tmemory.accountant().stages()
    jmemory.start()
    _run_lm(lambda s: jax_parse_launch(s, fuse=False),
            LM.format(acc="", fw="jax", pkg="nnstreamer_tpu"))
    want = jmemory.accountant().stages()
    assert set(got) == set(want) == {"pipeline:f"}
    params = lm_serving.tiny.build_params(torch.device("cpu"))
    nbytes = tmemory.tree_nbytes(params)
    assert got["pipeline:f"]["param_bytes"] == nbytes
    assert want["pipeline:f"]["param_bytes"] == nbytes
    assert got["pipeline:f"]["kind"] == want["pipeline:f"]["kind"] == "filter"
    # CPU: no measured channels (the reference's come from XLA)
    assert got["pipeline:f"]["temp_bytes"] == 0
    model = "nnstreamer_tpu_torch.models.lm_serving:tiny"
    assert tmemory.accountant().models() == {model: nbytes}


def test_callable_param_nbytes_matches_on_closures():
    w = np.ones((16, 4), np.float32)
    b = np.zeros(4, np.float32)

    def model(x):
        return x @ w + b

    import functools

    part = functools.partial(lambda x, p: x, p={"w": w, "more": [b, w]})
    for fn in (model, part):
        assert tmemory.callable_param_nbytes(fn) == \
            jmemory.callable_param_nbytes(fn) == w.nbytes + b.nbytes


def test_callable_param_nbytes_walks_modules_and_instances():
    lin = torch.nn.Linear(8, 4)
    expect = sum(p.numel() * p.element_size() for p in lin.parameters())

    class Served:
        def __init__(self):
            self.model = lin

        def __call__(self, x):
            return self.model(x)

    assert tmemory.callable_param_nbytes(Served()) == expect
    assert tmemory.callable_param_nbytes(Served().__call__) == expect
    assert tmemory.callable_param_nbytes(lin) == expect


@pytest.mark.parametrize("caps", [
    "other/tensors,format=static,dimensions=8,types=float32",
    "other/tensors,format=static,num_tensors=2,dimensions=3:224:224:4.1001:4,"
    "types=uint8.float32",
    "other/tensors,format=flexible",
    "video/x-raw,width=4,height=4,format=RGB"])
def test_caps_frame_nbytes_matches(caps):
    assert tmemory.caps_frame_nbytes(parse_caps_string(caps)) == \
        jmemory.caps_frame_nbytes(jparse_caps(caps))
    assert tmemory.caps_frame_nbytes(None) == 0


def test_bfloat16_frame_bytes():
    caps = parse_caps_string(
        "other/tensors,format=static,dimensions=8:2,types=bfloat16")
    assert tmemory.caps_frame_nbytes(caps) == 32


def test_queue_bytes_tracked_while_playing_then_swept():
    pipe = parse_launch(QLINE.format(n=-1))
    pipe.play()
    try:
        deadline = time.monotonic() + 30
        q = pipe.get("q0")
        while time.monotonic() < deadline:
            if q.sink_pads[0].caps is not None:
                break
            time.sleep(0.01)
        qb = tmemory.queue_bytes(pipe)
        assert qb["q0"]["frame_bytes"] == 8 * 4
        assert qb["q0"]["bytes"] == qb["q0"]["depth"] * 32
        assert pipe.name in tmemory.snapshot()["queues"]
        assert f'pipeline="{pipe.name}"' in tmetrics.render()
    finally:
        pipe.stop()
    assert pipe.name not in tmemory.snapshot()["queues"]
    assert f'pipeline="{pipe.name}"' not in tmetrics.render()


def _memory_artifact(mod, pmod, pipe, fields):
    mod.reset()
    for name, kind, f in fields:
        mod.record_stage(f"{pipe.name}:{name}", kind, **f)
    return pmod.ProfileArtifact.capture(pipe, model_version="v",
                                        profiler=pmod.Profiler())


def test_artifact_memory_section_cross_loads_and_merges(tmp_path):
    line = QLINE.format(n=2)
    a_fields = [("q0", "queue", {"temp_bytes": 100, "output_bytes": 5})]
    b_fields = [("q0", "queue", {"temp_bytes": 40, "param_bytes": 70}),
                ("out", "sink", {"argument_bytes": 8})]
    port = _memory_artifact(tmemory, tprofile, parse_launch(line), a_fields)
    ref = _memory_artifact(jmemory, jprofile, jax_parse_launch(line),
                           b_fields)
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    t = tprofile.ProfileArtifact.load(str(tmp_path / "port.json")).merge(
        tprofile.ProfileArtifact.load(str(tmp_path / "ref.json")))
    j = jprofile.ProfileArtifact.load(str(tmp_path / "port.json")).merge(
        jprofile.ProfileArtifact.load(str(tmp_path / "ref.json")))
    assert t.memory == j.memory
    # per-field max, total recomputed from the merged fields
    assert t.memory["q0"]["temp_bytes"] == 100
    assert t.memory["q0"]["total_bytes"] == 100 + 5 + 70
    assert t.summary()["memory"] == j.summary()["memory"]


def test_budget_env_and_override(monkeypatch):
    for mod in (tmemory, jmemory):
        assert mod.default_budget_bytes() is None
        mod.set_budget(1 << 20)
        assert mod.default_budget_bytes() == 1 << 20
        monkeypatch.setenv(mod.BUDGET_ENV, "2e6")
        assert mod.default_budget_bytes() == 2000000
        monkeypatch.setenv(mod.BUDGET_ENV, "bogus")
        assert mod.default_budget_bytes() == 1 << 20
        monkeypatch.delenv(mod.BUDGET_ENV)
        mod.set_budget(None)


@pytest.mark.parametrize("err", [
    MemoryError("x"), RuntimeError("RESOURCE_EXHAUSTED: HBM"),
    RuntimeError("Out of memory while trying"), ValueError("shape"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")])
def test_looks_like_oom_matches(err):
    want = jmemory.looks_like_oom(err) if not isinstance(
        err, torch.cuda.OutOfMemoryError) else True
    assert tmemory.looks_like_oom(err) == want


def test_measured_record_reads_like_an_xla_analysis():
    rec = tmemory.MeasuredMemory(temp=1000, output=64, argument=32)
    assert tmemory.compiled_bytes(rec) == {
        "temp_bytes": 1000, "output_bytes": 64, "argument_bytes": 32,
        "generated_code_bytes": 0}
    assert tmemory.compiled_bytes(object()) is None
    tmemory.record_compiled("p:f", "filter", rec, param_bytes=7)
    assert tmemory.accountant().stage("p:f")["total_bytes"] == 1103


def test_torch_backend_measures_nothing_on_the_cpu():
    from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                    FilterProperties)
    from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

    be = TorchBackend()
    be.open(FilterProperties(model="builtin://scaler?factor=2",
                             accelerator=Accelerator.CPU))
    be.measure_next_invoke()
    out = be.invoke([np.ones(4, np.float32)])
    assert out[0].tolist() == [2.0] * 4
    assert be.memory_analysis([np.ones(4, np.float32)]) is None
    assert be._mem_arm is False


def test_oom_invoke_lands_in_the_flight_recorder():
    pipe, msg = _run_lm(line=(
        "appsrc name=in caps=other/tensors,format=static,dimensions=4,"
        "types=float32 ! tensor_filter name=f framework=torch "
        "accelerator=cpu model=test_torch_memory_acct:oom_model "
        "! tensor_sink name=out"), feed=np.ones(4, np.float32))
    assert msg.type.value == "error"
    ev = [e for e in tflight.dump(category="memory")
          if e["name"] == "alloc_failure"][-1]
    assert ev["data"]["stage"] == "pipeline:f"
    assert ev["pipeline"] == pipe.name
    assert "OutOfMemoryError" in ev["data"]["error"]


def test_no_card_no_device_rows():
    assert tmemory.sample_devices() == []
    assert tmemory.used_fraction() == 0.0
    assert tmemory.device_peaks() == {}


def test_sampler_thread_starts_and_joins():
    tmemory.start(sample_interval_s=0.01)
    names = {t.name for t in threading.enumerate()}
    assert "obs-memory-sampler" in names
    time.sleep(0.05)
    tmemory.stop()
    assert "obs-memory-sampler" not in {t.name for t in threading.enumerate()}
    assert not tmemory.ACTIVE


def test_calibration_refcount():
    tmemory.begin_calibration()
    tmemory.begin_calibration()
    tmemory.end_calibration()
    assert tmemory.ACTIVE
    tmemory.end_calibration()
    assert not tmemory.ACTIVE


def _mem_snapshot():
    return {"devices": [{"device": "cuda:0", "bytes_in_use": 3 << 30,
                         "peak_bytes": 5 << 30, "budget_bytes": 80 << 30,
                         "used_fraction": 3 / 80},
                        {"device": "cpu:0", "bytes_in_use": 512,
                         "peak_bytes": 2048, "budget_bytes": None,
                         "used_fraction": 0.0}],
            "stages": {"p:f": {"total_bytes": 12345678,
                               "param_bytes": 10000000,
                               "temp_bytes": 2345678},
                       "p:g": {"total_bytes": 0}},
            "queues": {"p": {"q": {"depth": 2, "frame_bytes": 4096,
                                   "bytes": 8192}}},
            "serving": {"kv": {"bytes": 1 << 20, "peak_bytes": 2 << 20,
                               "pages_total": 64, "pages_used": 16,
                               "pages_shared": 3,
                               "spec_acceptance_rate": 0.375},
                        "guard:g": {"bytes": 0}}}


def test_render_section_matches():
    snap = _mem_snapshot()
    assert tmemory.render_section(snap) == jmemory.render_section(snap)
    assert tmemory.render_section({}) == []
    assert tprofile.render_top({}, [], memory=snap) == \
        jprofile.render_top({}, [], memory=snap)


def test_snapshot_shape_and_gauges():
    tmemory.start()
    _run_lm()
    snap = tmemory.snapshot()
    assert set(snap) == set(jmemory.snapshot())
    assert snap["active"] and "pipeline:f" in snap["stages"]
    text = tmetrics.render()
    assert 'nns_memory_stage_bytes{field="params",stage="pipeline:f"}' \
        in text or 'stage="pipeline:f",field="params"' in text
    assert "nns_memory_model_params_bytes" in text
