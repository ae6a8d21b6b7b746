"""Device-segment fusion (runtime/fusion.py): the port against
nnstreamer_tpu.

Every launch line runs through both packages — nnstreamer_tpu on JAX-CPU,
the port with ``accelerator=cpu`` — and the port once more with
``fuse=False``. Compared exactly: the segment plans (members by canonical
name, barrier reasons), the per-sink records (buffers as raw bytes, then
the events in order, EOS last), and the segments' ``dispatches``,
``retraces`` and ``defused`` counts. On the CPU the port composes a
segment's stages into one call; the CUDA-graph capture is held on the
card (``tests/test_torch_fusion_cuda.py``).

The cases of nnstreamer_tpu's ``tests/test_fusion.py`` with ``tensor_if``,
``tensor_mux``/``tensor_demux``, the sparse codecs and ``invoke-dynamic``/
``suspend`` are in ``tests/test_torch_fusion_streams.py``, the model-swap
case in ``tests/test_torch_filter_props.py``; canary routers, AOT and
lint wait for the ROADMAP items that bring them."""
import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.runtime.fusion import plan_segments as jplan
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu.runtime.pipeline import Pipeline as JPipeline
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
from nnstreamer_tpu_torch.core import Event
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.runtime.fusion import plan_segments
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.runtime.pipeline import Pipeline

SRC = ("tensor_src num-buffers=6 dimensions=8 types=float32 "
       "pattern=counter ")
ADD = "tensor_transform mode=arithmetic option=add:1 {acc}"
MUL = "tensor_transform mode=arithmetic option=mul:2 {acc}"
SCALER = "tensor_filter framework={fw} model=builtin://scaler?factor=2 {acc}"


@pytest.fixture(autouse=True)
def _tsan_clean():
    before = len(tsan.violations())
    yield
    assert tsan.violations()[before:] == []


def _port_line(line):
    return line.format(fw="torch", acc="accelerator=cpu ")


def _ref_line(line):
    return line.format(fw="jax", acc="")


def port(line, fuse=None):
    return parse_launch(_port_line(line), fuse=fuse)


def ref(line, fuse=None):
    return jax_parse_launch(_ref_line(line), fuse=fuse)


def _bytes(t):
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.ascontiguousarray(t).tobytes()


def probe_sinks(pipe):
    """Per-sink record streams: buffers as raw bytes, events by type (CAPS
    with its caps string) — compared per sink (cross-branch interleave is
    thread timing, not semantics)."""
    records = {}
    for el in pipe.sinks:
        seq = records[el.name] = []

        def render(buf, _seq=seq, _el=el):
            _seq.append(("buf", tuple(_bytes(t)
                                      for t in buf.as_numpy().tensors)))
            type(_el).render(_el, buf)

        def hse(pad, event, _seq=seq, _el=el):
            caps = event.data.get("caps") if event.data else None
            _seq.append(("event", event.type.name,
                         str(caps) if caps is not None else ""))
            type(_el).handle_sink_event(_el, pad, event)

        el.render = render
        el.handle_sink_event = hse
    return records


def run_probed(parse, line, fuse=None, timeout=60.0):
    pipe = parse(line, fuse=fuse)
    records = probe_sinks(pipe)
    pipe.run(timeout=timeout)
    return pipe, records


def _plan(plan, pipe, canon):
    by_name = pipe.elements
    return ([[canon(e) for e in seg] for seg in plan.segments],
            {canon(by_name[n]): r for n, r in plan.barriers.items()})


def _same_plan(line, min_run=2):
    p, j = port(line), ref(line)
    got = _plan(plan_segments(p, min_run), p, tprofile.canonical_base)
    want = _plan(jplan(j, min_run), j, jprofile.canonical_base)
    assert got == want
    return got


def _seg_counts(pipe):
    return [{k: s.stats[k] for k in ("elements", "dispatches", "retraces",
                                      "defused", "aot_hits", "aot_exports")}
            for s in pipe.fused_segments]


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

PLAN_LINES = {
    "linear_run": SRC + f"! {ADD}! {MUL}! {SCALER}! tensor_sink",
    "queue_breaks": SRC + f"! {ADD}! {MUL}! queue ! {ADD}! {MUL}! tensor_sink",
    "single_element": SRC + f"! {ADD}! tensor_sink",
    "tee_and_serving": (
        SRC + "! tee name=t t. ! queue ! " + ADD + "! " + MUL +
        "! tensor_sink name=a t. ! queue ! tensor_serving framework={fw} "
        "model=builtin://scaler?factor=2 {acc}! tensor_sink name=b"),
    "sync_invoke": SRC + f"! {ADD}! {SCALER}sync-invoke=true ! tensor_sink",
    "latency_report": SRC + f"! {ADD}! {SCALER}latency-report=true "
                            "! tensor_sink",
    "host_barriers": (
        SRC + f"! {ADD}! {MUL}! tensor_decoder mode=octet_stream "
        "! tensor_converter input-dim=32 input-type=uint8 "
        f"! {ADD}! {MUL}! tensor_sink"),
    "fault_between": (SRC + f"! {ADD}! tensor_fault ! {MUL}! {ADD}"
                      "! tensor_sink"),
}


@pytest.mark.parametrize("name", sorted(PLAN_LINES))
def test_plan_matches_the_reference(name):
    segs, barriers = _same_plan(PLAN_LINES[name])
    if name == "linear_run":
        assert [len(s) for s in segs] == [3]
    if name == "queue_breaks":
        assert [len(s) for s in segs] == [2, 2]
        assert any("queue boundary" in r for r in barriers.values())
    if name == "single_element":
        assert segs == []
    if name == "tee_and_serving":
        reasons = " | ".join(barriers.values())
        assert "tee fan-out" in reasons and "FUSABLE=False" in reasons
    if name in ("sync_invoke", "latency_report"):
        assert segs == []
        key = {"sync_invoke": "sync-invoke",
               "latency_report": "latency profiling"}[name]
        assert any(key in r for r in barriers.values())
    if name == "host_barriers":
        assert [len(s) for s in segs] == [2, 2]
        assert any("host media parsing" in r for r in barriers.values())


@pytest.mark.parametrize("min_run", [1, 2])
def test_min_run_matches_the_reference(min_run):
    _same_plan(PLAN_LINES["queue_breaks"], min_run)
    _same_plan(SRC + f"! {SCALER}! queue ! {ADD}! tensor_sink", min_run)


def test_pure_device_cycle_is_rejected_not_fused():
    """A manually linked ring of fusable device elements never becomes a
    segment (a fused tail pushing into its own head would recurse)."""
    from nnstreamer_tpu.elements.transform import TensorTransform as J
    from nnstreamer_tpu_torch.elements.transform import TensorTransform as T

    def ring(cls, pipe_cls, plan):
        a = cls(name="a", mode="arithmetic", option="add:1")
        b = cls(name="b", mode="arithmetic", option="mul:2")
        pipe = pipe_cls().add(a, b)
        a.link(b)
        b.link(a)
        p = plan(pipe)
        return p.segments, p.barriers

    got = ring(T, Pipeline, plan_segments)
    assert got == ring(J, JPipeline, jplan)
    assert got[0] == [] and any("cycle" in r for r in got[1].values())


def test_fuse_false_and_env_escape_hatch(monkeypatch):
    pipe = port(SRC + f"! {ADD}! {MUL}! tensor_sink", fuse=False)
    pipe.run(timeout=30)
    assert pipe.fused_segments == []
    monkeypatch.setenv("NNS_NO_FUSE", "1")
    assert Pipeline().fuse is False and JPipeline().fuse is False
    monkeypatch.delenv("NNS_NO_FUSE")
    assert Pipeline().fuse is True


def test_affinity_tags_match_the_reference():
    from nnstreamer_tpu.registry.elements import get_factory as jget
    from nnstreamer_tpu_torch.registry.elements import (
        _FACTORIES,
        element_factories,
    )

    for name in element_factories():
        mine, cls = _FACTORIES[name], jget(name)
        assert (mine.DEVICE_AFFINITY, mine.FUSABLE, mine.FUSION_BARRIER) == \
            (cls.DEVICE_AFFINITY, cls.FUSABLE, cls.FUSION_BARRIER), name
    src = parse_launch("tensor_src device=true accelerator=cpu ! tensor_sink")
    assert src.sources[0].device_affinity() == "device"


# ---------------------------------------------------------------------------
# byte parity: fused == fuse=False == nnstreamer_tpu
# ---------------------------------------------------------------------------

PARITY_LINES = {
    "transform_chain_3":
        SRC + f"! {ADD}! {MUL}! tensor_transform mode=typecast "
        "option=float32 {acc}! tensor_sink name=out",
    "device_chain_8":
        SRC + "! " + "! ".join([ADD] * 4 + [MUL] * 4) + "! tensor_sink name=out",
    "filter_chain":
        SRC + f"! {SCALER}! tensor_filter framework={{fw}} "
        "model=builtin://add?value=3 {acc}! tensor_sink name=out",
    "mixed_transform_filter":
        SRC + f"! {ADD}! {SCALER}! {MUL}! tensor_sink name=out",
    "arith_chain_options":
        SRC + "! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-0.5,mul:2 {acc}! tensor_transform "
        "mode=clamp option=0:100 {acc}! tensor_sink name=out",
    "queue_boundary":
        SRC + f"! {ADD}! {MUL}! queue ! {MUL}! {ADD}! tensor_sink name=out",
    "tee_two_fused_branches":
        SRC + "! tee name=t "
        f"t. ! queue ! {ADD}! {MUL}! tensor_sink name=a "
        f"t. ! queue ! {MUL}! {MUL}! tensor_sink name=b",
    "apply_indices_multi_tensor":
        "tensor_src num-buffers=5 dimensions=4.4 types=float32 "
        "pattern=counter ! tensor_transform mode=arithmetic "
        "option=add:1 apply=0 {acc}! tensor_transform mode=arithmetic "
        "option=mul:3 apply=1 {acc}! tensor_sink name=out",
    "combinations_passthrough":
        "tensor_src num-buffers=5 dimensions=4.4 types=float32 "
        "pattern=counter ! tensor_filter framework={fw} "
        "model=builtin://scaler?factor=2 input-combination=0 "
        f"output-combination=i1,o0 {{acc}}! {ADD}! tensor_sink name=out",
    "capsfilter_mid_chain":
        SRC + "! tensor_transform mode=typecast option=float32 {acc}"
        f"! other/tensors ! {ADD}! tensor_sink name=out",
    "shared_backend_key":
        SRC + "! tensor_filter framework={fw} "
        "model=builtin://scaler?factor=2 shared-tensor-filter-key=fkey "
        "{acc}! tensor_filter framework={fw} "
        "model=builtin://scaler?factor=2 shared-tensor-filter-key=fkey "
        "{acc}! tensor_sink name=out",
    "device_born_stream":
        "tensor_src device=true num-buffers=5 dimensions=8 "
        f"types=float32 pattern=counter {{acc}}! {ADD}! {MUL}! {SCALER}"
        "! tensor_sink name=out",
    "uint8_typecast_normalize":
        "tensor_src num-buffers=4 dimensions=3:4:4:2 types=uint8 "
        "pattern=random seed=3 ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 {acc}! "
        f"{SCALER}! tensor_sink name=out",
}


@pytest.mark.parametrize("name", sorted(PARITY_LINES))
def test_fusion_byte_parity(name):
    """Fused output is byte-identical to fuse=False and to nnstreamer_tpu
    (fused), with identical per-sink event sequences and EOS last."""
    line = PARITY_LINES[name]
    fused_pipe, fused = run_probed(port, line, fuse=True)
    plain_pipe, plain = run_probed(port, line, fuse=False)
    ref_pipe, want = run_probed(ref, line)
    assert plain_pipe.fused_segments == []
    assert fused == plain == want
    for sink, recs in fused.items():
        kinds = [r[0] for r in recs]
        assert kinds.count("buf") > 0
        assert recs[-1] == ("event", "EOS", "")
    assert _seg_counts(fused_pipe) == _seg_counts(ref_pipe)


def test_parity_suite_actually_fuses():
    """The suite tests something: the 8-element chain is one segment with
    one composed program for six dispatches, and its counters reach the
    element-stats and metrics surfaces."""
    fused_pipe, _ = run_probed(port, PARITY_LINES["device_chain_8"])
    (seg,) = fused_pipe.fused_segments
    assert seg.stats["elements"] == 8
    assert seg.stats["dispatches"] == 6
    assert seg.stats["retraces"] == 1
    assert any(k.startswith("fused:") for k in fused_pipe.element_stats())


def test_fused_metrics_collector():
    pipe = port(SRC.replace("num-buffers=6", "num-buffers=-1")
                + f"! {ADD}! {MUL}! tensor_sink name=out max-stored=1")
    pipe.play()
    try:
        out = pipe.get("out")
        import time

        deadline = time.monotonic() + 10
        while out.buffer_count < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        text = tmetrics.render()
        (seg,) = pipe.fused_segments
        assert "nns_fused_dispatches_total" in text
        assert f'pipeline="{pipe.name}",segment="{seg.name}"' in text
    finally:
        pipe.stop()
    assert f'pipeline="{pipe.name}"' not in tmetrics.render()


def test_profiler_and_tracer_see_the_segment():
    from nnstreamer_tpu_torch.utils import trace

    tprofile.start()
    trace.install_tracers(["proctime"])
    try:
        pipe, _ = run_probed(port, PARITY_LINES["device_chain_8"])
        snap = tprofile.snapshot()
    finally:
        tprofile.stop()
        trace.uninstall_tracers()
    (seg,) = pipe.fused_segments
    fused = snap["durations"]["fused"]
    key = f"{pipe.name}:{tprofile.canonical_base(seg.head)}.." \
          f"{tprofile.canonical_base(seg.tail)}"
    assert fused[key]["count"] == 6
    tprofile.reset()


def _obs_run(parse, profile, quality, trace_mod, line):
    """One fused run with the profiler, the quality taps and a recording
    tracer on: the fused series' counts, the quality entries and the
    tracer's fused spans."""
    class Spans(trace_mod.Tracer):
        def __init__(self):
            self.spans = []

        def buffer_flow(self, pad, buf, elapsed_s):
            pass

        def serving_event(self, kind, name, start_s, dur_s, meta):
            self.spans.append((kind, name, dict(meta)))

    rec = Spans()
    profile.start()
    quality.start()
    trace_mod.install_tracer(rec)
    try:
        pipe, records = run_probed(parse, line)
        durations = profile.snapshot()["durations"]
        stages = quality.snapshot()["stages"]
    finally:
        profile.stop()
        quality.stop()
        trace_mod.uninstall_tracers()
        profile.reset()
        quality.reset()
    prefix = f"{pipe.name}:"

    def local(key):
        assert key.startswith(prefix)
        return key[len(prefix):]

    fused = {ch: {local(k): v["count"] for k, v in durations[ch].items()}
             for ch in ("fused", "fused_device")}
    health = {local(k): v for k, v in stages.items()}
    # span names are element names; name them by canonical member names
    canon = {seg.name: f"{profile.canonical_base(seg.head)}.."
                       f"{profile.canonical_base(seg.tail)}"
             for seg in pipe.fused_segments}
    spans = [(kind, canon[name], meta) for kind, name, meta in rec.spans]
    return pipe, records, fused, health, spans


def test_fused_observability_matches_the_reference():
    """The fused device chain with profiling, quality taps and a tracer
    on, in both packages: the same ``fused``/``fused_device`` series and
    counts, the same sampled fused (and edge) health entries, and the
    same ``fused`` spans, one a dispatch."""
    from nnstreamer_tpu.obs import quality as jquality
    from nnstreamer_tpu.utils import trace as jtrace
    from nnstreamer_tpu_torch.obs import quality as tquality
    from nnstreamer_tpu_torch.utils import trace as ttrace

    n = 32  # two latency probes (PROBE_EVERY 16), four taps (1 in 8)
    line = PARITY_LINES["device_chain_8"].replace(
        "num-buffers=6", f"num-buffers={n}")
    pipe, got_recs, got_fused, got_health, got_spans = _obs_run(
        port, tprofile, tquality, ttrace, line)
    _, want_recs, want_fused, want_health, want_spans = _obs_run(
        ref, jprofile, jquality, jtrace, line)
    assert got_recs == want_recs
    (seg,) = pipe.fused_segments
    key = (f"{tprofile.canonical_base(seg.head)}.."
           f"{tprofile.canonical_base(seg.tail)}")
    assert got_fused == want_fused == {"fused": {key: n},
                                       "fused_device": {key: 2}}
    assert got_health[key]["kind"] == "fused"
    assert got_health[key]["buffers"] == n // 8
    assert got_health == want_health
    assert got_spans == want_spans
    assert got_spans == [("fused", key, {"elements": 8})] * n


# ---------------------------------------------------------------------------
# runtime fallback + donation
# ---------------------------------------------------------------------------

class TestRuntimeFallback:
    def test_member_without_stage_defuses(self, monkeypatch):
        """A backend that hands out no stage (nnstreamer_tpu: a pinned
        device) defuses the segment at resolve time; the per-element path
        serves every buffer, byte-identical, and the counts equal the
        reference's pinned filter's."""
        line = SRC + f"! {ADD}! {SCALER}! tensor_sink name=out"
        monkeypatch.setattr(TorchBackend, "fusion_callable",
                            lambda self: None)
        fused_pipe, fused = run_probed(port, line)
        _, plain = run_probed(port, line, fuse=False)
        ref_pipe, want = run_probed(
            ref, line.replace("scaler?factor=2 ",
                              "scaler?factor=2 custom=device:0 "))
        assert fused == plain == want
        (seg,) = fused_pipe.fused_segments
        assert seg.stats["defused"] == 1 and seg.stats["dispatches"] == 0
        assert _seg_counts(fused_pipe) == _seg_counts(ref_pipe)

    def test_pinned_to_another_card_gives_no_stage(self):
        b = TorchBackend()
        b._fn = lambda x: x
        from nnstreamer_tpu_torch.backends.base import FilterProperties

        b.props = FilterProperties(custom="device:1")
        assert b.fusion_callable() is None
        b.props = FilterProperties(custom="device:0")
        assert b.fusion_callable() is not None

    def test_on_a_card_only_declared_models_give_a_stage(self):
        """A CUDA graph bakes in host reads and cannot hold a host sync,
        so on a card only a model that declares ``capture_safe`` becomes a
        stage (the zoo's entries, the builtins but sleeper); the LM entry
        and a user's plain callable do not. On the CPU every model does.
        The backend is set as if opened on a card; nothing runs."""
        from nnstreamer_tpu_torch.backends.base import FilterProperties
        from nnstreamer_tpu_torch.backends.torch_backend import make_builtin
        from nnstreamer_tpu_torch.models import _blocks
        from nnstreamer_tpu_torch.models.lm_serving import tiny

        b = TorchBackend()
        b.props = FilterProperties()
        lm = tiny.make(device=torch.device("cpu"))
        cases = [(lambda x: (x,), False), (lm, False),
                 (make_builtin("builtin://scaler"), True),
                 (make_builtin("builtin://sleeper"), False)]
        for fn, safe in cases:
            b._fn = fn
            b._device = torch.device("cuda", 0)
            assert (b.fusion_callable() is not None) is safe
            b._device = torch.device("cpu")
            assert b.fusion_callable() is not None
        assert _blocks.ServedModel.capture_safe
        assert _blocks._U8Served.capture_safe

    def test_a_syncing_user_model_fuses_on_the_cpu(self, monkeypatch):
        """A user model that reads a value on the host runs in a fused
        segment on the CPU (nothing is captured there), its records equal
        to ``fuse=False``'s and its buffers to the reference's (a plain
        callable declares no output shape, so the port's caps are
        flexible where nnstreamer_tpu traces a static one)."""
        import sys
        import types

        for pkg, torch_side in (("_nns_fusion_sync_port", True),
                                ("_nns_fusion_sync_ref", False)):
            mod = types.ModuleType(pkg)
            if torch_side:
                mod.model = lambda x: ((x * 2,) if float(x.sum().item()) >= 0
                                       else (x,))
            else:
                mod.model = lambda x: (x * 2,)
            monkeypatch.setitem(sys.modules, pkg, mod)
        line = (SRC + f"! {ADD}! tensor_filter framework={{fw}} "
                "model={mod}:model {acc}! tensor_sink name=out")
        port_line = line.replace("{mod}", "_nns_fusion_sync_port")
        fused_pipe, fused = run_probed(port, port_line)
        _, plain = run_probed(port, port_line, fuse=False)
        _, want = run_probed(ref, line.replace("{mod}",
                                               "_nns_fusion_sync_ref"))
        assert fused == plain

        def bufs(records):
            return [r for r in records["out"] if r[0] == "buf"]
        assert len(bufs(fused)) == 6 and bufs(fused) == bufs(want)
        (seg,) = fused_pipe.fused_segments
        assert seg.stats["dispatches"] == 6 and seg.stats["defused"] == 0

    def test_donation_enabled_only_behind_fresh_device_producer(self):
        line = (SRC + f"! {SCALER}latency-report=true ! {ADD}! {MUL}"
                "! tensor_sink name=out")
        fused_pipe, fused = run_probed(port, line)
        _, plain = run_probed(port, line, fuse=False)
        ref_pipe, want = run_probed(ref, line)
        assert fused == plain == want
        (seg,) = fused_pipe.fused_segments
        (jseg,) = ref_pipe.fused_segments
        assert seg._donate is jseg._donate is True
        pipe2, _ = run_probed(port, PARITY_LINES["tee_two_fused_branches"])
        assert all(s._donate is False for s in pipe2.fused_segments)

    def test_donation_blocked_by_transitive_aliasing(self):
        """output-combination i<N> passthrough re-emits the producer's
        INPUT tensors, which a tee further upstream still shares: the
        transitive walk refuses donation."""
        line = (SRC + "! tee name=t "
                "t. ! queue ! tensor_filter framework={fw} "
                "model=builtin://scaler?factor=2 input-combination=0 "
                "output-combination=i0 latency-report=true {acc}"
                f"! {ADD}! {MUL}! tensor_sink name=a "
                "t. ! queue ! tensor_sink name=b")
        fused_pipe, fused = run_probed(port, line)
        _, plain = run_probed(port, line, fuse=False)
        ref_pipe, want = run_probed(ref, line)
        assert fused == plain == want
        (seg,) = fused_pipe.fused_segments
        (jseg,) = ref_pipe.fused_segments
        assert seg._donate is jseg._donate is False


# ---------------------------------------------------------------------------
# cache invalidation: caps, restart
# ---------------------------------------------------------------------------

class TestInvalidation:
    def test_caps_renegotiation_invalidates(self):
        """Replaying re-announces caps: the fresh run re-plans and
        re-resolves (no stale program across play/stop/play)."""
        line = SRC + f"! {ADD}! {MUL}! tensor_sink name=out"
        pipe = port(line)
        pipe.run(timeout=30)
        (seg1,) = pipe.fused_segments
        assert seg1.stats["dispatches"] == 6
        pipe.run(timeout=30)  # replay
        (seg2,) = pipe.fused_segments
        assert seg2 is not seg1
        assert seg2.stats["dispatches"] == 6
        assert pipe.get("out").buffer_count >= 6

    def test_caps_event_on_a_member_drops_the_program(self):
        line = SRC + f"! {ADD}! {MUL}! tensor_sink name=out"
        pipe = port(line)
        pipe.run(timeout=30)
        (seg,) = pipe.fused_segments
        assert seg._call is not None
        gen = seg._gen
        member = seg.elements[1]
        caps = member.sinkpad.caps
        member._handle_sink_event_guarded(member.sinkpad, Event.caps(caps))
        assert seg._call is None and seg._gen == gen + 1

    def test_replay_replans_from_scratch(self):
        """A replay (the supervised-restart path: play() after stop())
        installs fresh segments, and the reference does the same."""
        line = SRC + f"! {ADD}! {SCALER}! tensor_sink name=out"
        got, want = [], []
        for parse, out in ((port, got), (ref, want)):
            pipe = parse(line)
            for _ in range(2):
                recs = probe_sinks(pipe)
                pipe.run(timeout=30)
                out.append((recs, _seg_counts(pipe)))
        assert got == want
        assert got[0] == got[1]


def test_throttle_gate_drops_on_fused_path():
    pipe = port(
        "tensor_src num-buffers=30 framerate=300 dimensions=4 "
        f"types=float32 pattern=counter ! {ADD}! tensor_filter "
        "framework={fw} model=builtin://scaler?factor=2 name=f {acc}"
        "! tensor_sink name=out max-stored=64")
    f = pipe.get("f")
    f._throttle_delay_s = 0.05  # as a tensor_rate QoS event would set
    pipe.run(timeout=30)
    out = pipe.get("out")
    (seg,) = pipe.fused_segments
    assert seg.stats["dispatches"] > 0
    # 30 frames at ~300fps against a 20fps throttle: most frames drop
    assert 1 <= out.buffer_count < 30
