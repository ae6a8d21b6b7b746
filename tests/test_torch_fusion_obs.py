"""The fused device chain's observability output, held against
nnstreamer_tpu with fusion ON in both packages.

The eight-transform device chain of the fusion parity lines runs fused
in both packages with the continuous profiler, the quality taps and
request tracing on, each buffer carrying a request's trace context.
Compared exactly: every profiler series (channel, key, count) — the
``fused`` and ``fused_device`` series and the absence of per-member
series for the fused elements; the quality plane's stage entries, the
fused tap's included; and the ``fused:<head>..<tail>`` spans (name,
kind, parent, attributes), one a dispatch. nnstreamer_tpu is never
changed to make the two agree."""
import numpy as np
import pytest

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.obs import context as jcontext
from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.obs import quality as jquality
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.obs import context as tcontext
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.obs import quality as tquality
from nnstreamer_tpu_torch.runtime.parse import parse_launch

N = 32  # two latency probes (PROBE_EVERY 16), four taps (1 in 8)

# PARITY_LINES["device_chain_8"] of test_torch_fusion.py, fed by an appsrc
# so each buffer can carry a trace context, its members named so span
# names compare across packages
CHAIN = " ! ".join(
    [f"tensor_transform name=add{i} mode=arithmetic option=add:1 {{acc}}"
     for i in range(4)]
    + [f"tensor_transform name=mul{i} mode=arithmetic option=mul:2 {{acc}}"
       for i in range(4)])
LINE = ("appsrc name=in caps=other/tensors,format=static,dimensions=8,"
        "types=float32 ! " + CHAIN + " ! tensor_sink name=out")

PACKAGES = {
    "port": (parse_launch, Buffer, tprofile, tquality, tcontext,
             "accelerator=cpu"),
    "reference": (jax_parse_launch, JBuffer, jprofile, jquality, jcontext,
                  ""),
}


def _run(which):
    parse, buf_cls, profile, quality, context, acc = PACKAGES[which]
    profile.reset()
    quality.reset()
    context.reset()
    profile.start()
    quality.start()
    context.enable_tracing()
    try:
        pipe = parse(LINE.format(acc=acc), fuse=True)
        outs = []
        pipe.get("out").connect(lambda b: outs.append(
            np.asarray(b.as_numpy().tensors[0]).tobytes()))
        root = context.start_span("request", kind="request")
        pipe.play()
        for i in range(N):
            pipe.get("in").push_buffer(buf_cls(
                [np.full(8, i, np.float32)],
                meta={"trace": root.context().to_meta()}))
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=60)
        pipe.stop()
        durations = profile.snapshot()["durations"]
        stages = quality.snapshot()["stages"]
        spans = [s for s in context.finished_spans()
                 if s.name.startswith("fused:")]
    finally:
        profile.stop()
        quality.stop()
        context.disable_tracing()
        profile.reset()
        quality.reset()
        context.reset()
    prefix = f"{pipe.name}:"

    def local(key):
        return key[len(prefix):] if key.startswith(prefix) else key

    series = {ch: {local(k): v["count"] for k, v in by_key.items()}
              for ch, by_key in durations.items() if by_key}
    health = {local(k): v for k, v in stages.items()}
    span_recs = [(s.name, s.kind, s.parent_id == root.span_id,
                  s.trace_id == root.trace_id, dict(s.attrs))
                 for s in spans]
    return pipe, outs, series, health, span_recs


@pytest.fixture(scope="module")
def both():
    return _run("port"), _run("reference")


def test_both_runs_fuse_the_chain(both):
    (ppipe, pouts, *_), (rpipe, routs, *_) = both
    assert [len(s.elements) for s in ppipe.fused_segments] == \
        [len(s.elements) for s in rpipe.fused_segments] == [8]
    assert pouts == routs and len(pouts) == N


def test_profiler_series_match_exactly(both):
    (_, _, got, _, _), (_, _, want, _, _) = both
    assert got == want
    key = "add0..mul3"
    assert got["fused"] == {key: N}
    assert got["fused_device"] == {key: N // 16}


def test_quality_entries_match_exactly(both):
    (_, _, _, got, _), (_, _, _, want, _) = both
    assert got == want
    assert got["add0..mul3"]["kind"] == "fused"
    assert got["add0..mul3"]["buffers"] == N // 8


def test_fused_spans_match_exactly(both):
    (_, _, _, _, got), (_, _, _, _, want) = both
    assert got == want
    assert got == [("fused:add0..mul3", "fused", True, True,
                    {"elements": 8})] * N
