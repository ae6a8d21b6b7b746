"""Pipeline tracers (utils/trace.py) and the Pad.push hook: the port
against nnstreamer_tpu on the same launch lines.

Each tracer runs over the same named launch line in both packages (the
port's transform with ``accelerator=cpu``); their result keys and buffer
counts must be equal — times differ between runs, counts may not. The
chrome trace loads as JSON with the same spans, the env activation
(``NNS_TRACERS``) and the dot dump (``NNS_DOT_DIR``) behave alike, and
``torch_trace`` writes a loadable trace into its directory."""
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu.utils import trace as jtrace
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.runtime import pad as tpad
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = ("tensor_src name=src num-buffers=5 dimensions=8 types=float32 "
        "pattern=ones ! queue name=q ! tensor_transform name=t "
        "mode=arithmetic option=mul:2 {acc}! tensor_sink name=out")
TRACERS = ("proctime", "framerate", "interlatency", "queuelevel")
# the count each tracer's rows carry; the other fields are times
COUNT_KEY = {"proctime": "buffers", "framerate": "frames",
             "interlatency": "buffers", "queuelevel": "samples"}


@pytest.fixture(autouse=True)
def _clean_tracers():
    before = len(tsan.violations())
    yield
    trace.uninstall_tracers()
    jtrace.uninstall_tracers()
    # NNS_TSAN=1: the port's named locks saw no lock-order violation
    assert tsan.violations()[before:] == []


def _run_port(line=LINE):
    pipe = parse_launch(line.format(acc="accelerator=cpu "))
    pipe.run(timeout=30)
    return pipe


def _run_ref(line=LINE):
    pipe = jax_parse_launch(line.format(acc=""), fuse=False)
    pipe.run(timeout=30)
    return pipe


def _counts(results: dict, name: str) -> dict:
    return {k: v[COUNT_KEY[name]] for k, v in results[name].items()}


@pytest.mark.parametrize("name", TRACERS)
def test_tracer_keys_and_counts_match(name):
    trace.install_tracers([name])
    _run_port()
    got = trace.trace_results()
    jtrace.install_tracers([name])
    _run_ref()
    want = jtrace.trace_results()
    assert set(got) == set(want) == {name}
    assert _counts(got, name) == _counts(want, name)
    for row_got, row_want in zip(got[name].values(), want[name].values()):
        assert set(row_got) == set(row_want)


def test_all_tracers_together_match():
    trace.install_tracers(list(TRACERS))
    _run_port()
    got = trace.trace_results()
    jtrace.install_tracers(list(TRACERS))
    _run_ref()
    want = jtrace.trace_results()
    for name in TRACERS:
        assert _counts(got, name) == _counts(want, name), name
    assert got["proctime"]["t"]["buffers"] == 5


def test_chrome_trace_spans_match(tmp_path):
    spans = {}
    for label, mod, run in (("port", trace, _run_port),
                            ("ref", jtrace, _run_ref)):
        tracer = mod.ChromeTraceTracer(path=str(tmp_path / f"{label}.json"))
        mod.install_tracer(tracer)
        try:
            run()
        finally:
            mod.uninstall_tracers()
        path = tracer.save()
        events = json.load(open(path))["traceEvents"]
        for e in events:
            assert e["ph"] == "X" and e["dur"] >= 0 and e["cat"] == "element"
        spans[label] = Counter(e["name"] for e in events)
    assert spans["port"] == spans["ref"]
    assert spans["port"]["t"] == 5


def test_unknown_tracer_rejected_alike():
    msgs = []
    for mod in (trace, jtrace):
        with pytest.raises(ValueError, match="unknown tracer") as ei:
            mod.install_tracers(["warpdrive"])
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_disabled_means_one_global_check(monkeypatch):
    """Tracing off: Pad.push never reaches the fan-out."""
    assert trace.ACTIVE is False

    def boom(*a, **k):
        raise AssertionError("notify_flow called with tracing off")

    monkeypatch.setattr(trace, "notify_flow", boom)
    _run_port()
    assert trace.trace_results() == {}
    assert tpad.trace is trace


def test_custom_tracer_sees_every_hop():
    seen = []

    class Mine(trace.Tracer):
        NAME = "mine"

        def buffer_flow(self, pad, buf, elapsed_s):
            seen.append((pad.full_name, elapsed_s >= 0))

        def results(self):
            return {"n": len(seen)}

    trace.install_tracer(Mine())
    _run_port()
    # three hops a buffer: src->q, q->t, t->out
    assert trace.trace_results()["mine"]["n"] == 15
    assert all(ok for _, ok in seen)
    trace.uninstall_tracer(trace._tracers[0])
    assert trace.ACTIVE is False


def test_dot_dump_on_play(tmp_path, monkeypatch):
    monkeypatch.setenv("NNS_DOT_DIR", str(tmp_path))
    pipe = parse_launch("tensor_src num-buffers=1 dimensions=2 "
                        "! tensor_sink name=out")
    pipe.run(timeout=20)
    dots = list(tmp_path.glob("*.dot"))
    assert [d.name for d in dots] == [f"{pipe.name}.play.dot"]
    text = dots[0].read_text()
    assert "tensor_src" in text and "->" in text


def test_nns_tracers_env_with_jax_blocked(tmp_path):
    """NNS_TRACERS installs at the first play() and env-activated chrome
    traces flush at stop() into NNS_TRACE_DIR, in a process where JAX
    cannot be imported."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'ml_dtypes', 'nnstreamer_tpu'):\n"
        "    sys.modules[n] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from nnstreamer_tpu_torch.runtime.parse import parse_launch\n"
        "from nnstreamer_tpu_torch.utils import trace\n"
        "pipe = parse_launch('tensor_src num-buffers=2 dimensions=2 "
        "! tensor_sink name=o')\n"
        "pipe.run(timeout=20)\n"
        "res = trace.trace_results()\n"
        "assert set(res) == {'proctime', 'framerate', 'chrometrace'}, res\n"
        "assert res['proctime']['o']['buffers'] == 2, res\n"
        "print('ENV_OK')\n")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "NNS_TRACERS": "proctime;framerate,chrometrace",
           "NNS_TRACE_DIR": str(tmp_path / "traces")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert "ENV_OK" in r.stdout, r.stderr
    files = list((tmp_path / "traces").glob("nns_trace-*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert Counter(e["name"] for e in events) == {"o": 2}


def test_serving_batches_reach_the_tracers(tmp_path):
    """tensor_serving's scheduler emits a ``batch`` span per executed
    batch through notify_serving, beside the element spans."""
    tracer = trace.ChromeTraceTracer(path=str(tmp_path / "s.json"))
    trace.install_tracer(tracer)
    try:
        pipe = parse_launch(
            "tensor_src num-buffers=3 dimensions=3:1 types=float32 "
            "pattern=ones ! tensor_serving name=sv framework=torch "
            "accelerator=cpu model=builtin://scaler?factor=2 "
            "bucket-sizes=1,2,4 ! tensor_sink name=out")
        pipe.run(timeout=30)
    finally:
        trace.uninstall_tracers()
    events = json.load(open(tracer.save()))["traceEvents"]
    batches = [e for e in events if e["cat"] == "serving"]
    assert batches and all(e["name"].startswith("batch:") for e in batches)
    assert sum(e["args"]["rows"] for e in batches) == 3
    assert Counter(e["name"] for e in events
                   if e["cat"] == "element")["out"] == 3


def test_torch_trace_writes_a_loadable_chrome_trace(tmp_path):
    import torch

    logdir = tmp_path / "prof"
    with trace.torch_trace(str(logdir), cuda=False) as prof:
        pipe = parse_launch(LINE.format(acc="accelerator=cpu "))
        pipe.run(timeout=30)
        torch.ones(4).sum()
    assert os.path.dirname(prof.trace_path) == str(logdir)
    doc = json.load(open(prof.trace_path))
    assert doc["traceEvents"], "empty trace"


def test_flush_keeps_recording_save_finalizes(tmp_path):
    tracer = trace.ChromeTraceTracer(path=str(tmp_path / "f.json"))
    tracer.buffer_flow(
        type("P", (), {"peer": None})(), Buffer([np.zeros(1)]), 0.0)
    assert tracer.flush() is None  # nothing recorded without a peer
    trace.install_tracer(tracer)
    _run_port()
    assert tracer.flush() == tracer.path
    n = len(json.load(open(tracer.path))["traceEvents"])
    assert n == 15
    assert tracer.save() == tracer.path
    assert tracer.save() is None  # finalized once
    assert tracer.results()["events"] == 0
