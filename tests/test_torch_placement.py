"""Profile-guided placement (runtime/placement.py) and pinned staging
(transport/staging.py): the port against nnstreamer_tpu.

The planner's algebra is fed ONE cost table in both packages — a profile
artifact captured by nnstreamer_tpu on JAX-CPU, loaded into the port's
``ProfileArtifact`` through the shared JSON schema — over device lists of
equal length (nnstreamer_tpu's 8 virtual CPU devices; the port's
``torch.device("cpu", i)``, labelled the same), and must give equal
assignments, queue depths and serialized plans. Runs on the CPU inject
that device list (the port's default is the CUDA cards). Sink bytes with
``place="auto"`` equal ``place=False`` and nnstreamer_tpu's.

Cases of nnstreamer_tpu's ``tests/test_placement.py`` that need parts
the port lacks wait for them: ``tensor_shard`` branch weights (ROADMAP
A6), NNL014 (A8), the ``parallel/pipeline`` assignment surfaces (A7)."""
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.runtime import placement as jplacement
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.runtime import placement
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.runtime.placement import (
    PlacementPlan,
    Planner,
    StagePlacement,
)
from nnstreamer_tpu_torch.transport.staging import DoubleBufferedStager

SRC = ("tensor_src num-buffers={n} dimensions=8 types=float32 "
       "pattern=counter ")
ADD = "tensor_transform mode=arithmetic option=add:1 {acc}"
MUL = "tensor_transform mode=arithmetic option=mul:2 {acc}"
SCALER = "tensor_filter framework={fw} model=builtin://scaler?factor=2 {acc}"

# 3 device stages over 2 queues: two fused segments + one singleton
MULTI = (SRC + f"! {ADD}! {MUL}! queue name=q0 max-size-buffers=16 "
         f"! {ADD}! {SCALER}! queue name=q1 max-size-buffers=16 "
         f"! {SCALER}! tensor_sink name=out max-stored=1")

N_DEV = 8
CPU_DEVICES = [torch.device("cpu", i) for i in range(N_DEV)]


def line(n=80):
    return MULTI.replace("{n}", str(n))


def port(launch, place=None):
    return parse_launch(launch.format(fw="torch", acc="accelerator=cpu "),
                        place=place)


def ref(launch, place=None):
    return jax_parse_launch(launch.format(fw="jax", acc=""), place=place)


@pytest.fixture(autouse=True)
def _farm(monkeypatch):
    """The port's default planner sees 8 CPU devices, as nnstreamer_tpu's
    sees its 8 virtual ones (tests/conftest.py)."""
    orig = Planner.devices.fget

    def devices(self):
        if self._devices is None:
            self._devices = list(CPU_DEVICES)
        return orig(self)

    monkeypatch.setattr(Planner, "devices", property(devices))
    before = len(tsan.violations())
    yield
    assert tsan.violations()[before:] == []


@pytest.fixture
def store(tmp_path, monkeypatch):
    root = str(tmp_path / "profiles")
    monkeypatch.setenv(tprofile.STORE_ENV, root)
    yield root


def run_placed(launch, place="auto"):
    pipe = port(launch, place=place)
    pipe.run(timeout=60)
    return pipe


def make_artifact(store_dir, n=120):
    """One calibrated run that persists an artifact into the store."""
    pipe = run_placed(line(n))
    assert os.listdir(store_dir), "calibration did not persist"
    return pipe


def ref_artifact():
    """nnstreamer_tpu's measured profile of the same line, as the JSON
    both packages read: the one cost table both planners are fed."""
    pipe = ref(line(120))
    jprofile.start()
    try:
        pipe.run(timeout=60)
    finally:
        jprofile.stop()
    art = jprofile.ProfileArtifact.capture(pipe)
    jprofile.reset()
    return json.loads(json.dumps(art.to_dict()))


def _both_plans(d, **kw):
    got = Planner(devices=CPU_DEVICES, **kw).plan(
        port(line()), artifact=tprofile.ProfileArtifact.from_dict(d))
    want = jplacement.Planner(devices=jax.devices()[:N_DEV], **kw).plan(
        ref(line()), artifact=jprofile.ProfileArtifact.from_dict(d))
    return got, want


# ---------------------------------------------------------------------------
# planner: one cost table, both packages
# ---------------------------------------------------------------------------

class TestPlannerAlgebra:
    def test_heuristic_plan_matches_the_reference(self, monkeypatch):
        monkeypatch.delenv(tprofile.STORE_ENV, raising=False)
        got = Planner().plan(port(line()))
        want = jplacement.Planner().plan(ref(line()))
        assert got.source == "heuristic" and len(got.stages) == 3
        assert len({s.device for s in got.stages}) == 3
        assert got.queues == {}
        assert got.to_dict() == want.to_dict()

    def test_profiled_plan_matches_the_reference(self):
        """Exact optimum, queue-depth rule and the serialized plan from
        one measured cost table."""
        d = ref_artifact()
        got, want = _both_plans(d)
        assert got.source == "profile"
        assert got.queues, "profiled queues must be tuned"
        for q in got.queues.values():
            assert (placement.MIN_QUEUE_DEPTH <= q["depth"]
                    <= placement.MAX_QUEUE_DEPTH)
        assert got.to_dict() == want.to_dict()

    @pytest.mark.parametrize("kw", [
        {"min_queue_depth": 1, "max_queue_depth": 2},
        {"min_queue_depth": 3, "max_queue_depth": 5},
        {"hbm_budget_bytes": 1 << 20},
    ])
    def test_planner_knobs_match_the_reference(self, kw):
        got, want = _both_plans(ref_artifact(), **kw)
        assert got.to_dict() == want.to_dict()

    @pytest.mark.parametrize("costs,n_dev,cap", [
        ((4.0, 2.0, 2.0, 1.0), 2, None),    # exact optimum {4,1}|{2,2}
        ((10.0, 1.0, 1.0, 1.0), 2, None),   # heavy stage isolated
        ((10.0, 1.0, 1.0, 1.0), 2, 2),      # byte budget forbids 3 + 1
        (tuple(float(1 + (7 * i) % 11) for i in range(20)), 2, None),  # LPT
        (tuple(float(1 + (5 * i) % 13) for i in range(9)), 3, 4),
    ])
    def test_assignment_matches_the_reference(self, costs, n_dev, cap):
        """``cap`` stages a card, as a byte budget over one-byte stages
        (the budget is the planner's one co-residency constraint)."""
        def assign(mod):
            stages = [mod.StagePlacement(f"s{i}", [f"s{i}"], 0, c, c,
                                         "profile", bytes=1)
                      for i, c in enumerate(costs)]
            load, mem, ok = mod.Planner(devices=[None] * n_dev)._assign(
                stages, n_dev, budgets=[cap] * n_dev)
            return [s.device for s in stages], load, mem, ok

        got = assign(placement)
        assert got == assign(jplacement)
        if costs == (4.0, 2.0, 2.0, 1.0):
            assert max(got[1]) == pytest.approx(5.0)

    def test_byte_budget_matches_the_reference(self):
        def assign(mod, budgets):
            stages = [mod.StagePlacement(k, [k], 0, c, c, "profile", bytes=b)
                      for k, c, b in zip("abcd", (4.0, 3.0, 2.0, 1.0),
                                         (60, 50, 40, 30))]
            out = mod.Planner(devices=[None, None])._assign(
                stages, 2, budgets=budgets)
            return [s.device for s in stages], out

        for budgets in ([100, 100], [90, 90], [50, 50]):
            assert assign(placement, budgets) == assign(jplacement, budgets)

    def test_plan_serialization_round_trip(self):
        got, _ = _both_plans(ref_artifact())
        d = json.loads(json.dumps(got.to_dict()))
        back = PlacementPlan.from_dict(d)
        assert back.to_dict() == got.to_dict()
        # the reference reads the port's plan, and back
        assert jplacement.PlacementPlan.from_dict(d).to_dict() == d
        with pytest.raises(ValueError):
            PlacementPlan.from_dict({"kind": "something-else"})

    def test_determinism_same_store_same_plan(self, store):
        make_artifact(store)
        a = Planner().plan(port(line()))
        b = Planner().plan(port(line()))
        assert a.source == "profile"
        assert a.to_dict() == b.to_dict()


# ---------------------------------------------------------------------------
# runtime application
# ---------------------------------------------------------------------------

class TestApply:
    def test_auto_assigns_segment_devices_and_queue_depths(self, store):
        pipe = make_artifact(store)
        segs = pipe.fused_segments
        assert segs and all(s.device is not None for s in segs)
        plan = pipe.placement_plan
        for canon, q in plan.queues.items():
            el = next(e for e in pipe.elements.values()
                      if tprofile.canonical_base(e) == canon)
            assert el.stats["capacity"] == q["depth"]
            assert el.stats["retuned"] >= 1

    def test_explicit_plan_applies_verbatim(self):
        plan = Planner().plan(port(line()))
        for st in plan.stages:
            st.device = 3
        pipe = run_placed(line(), place=plan)
        assert pipe.placement_plan.source == "explicit"
        for seg in pipe.fused_segments:
            assert seg.device == torch.device("cpu", 3)

    def test_place_off_and_kill_switch(self, monkeypatch):
        pipe = run_placed(line(), place=None)
        assert pipe.placement_plan is None
        assert all(s.device is None for s in pipe.fused_segments)
        monkeypatch.setenv("NNS_NO_PLACE", "1")
        assert port(line(), place="auto").place is None

    def test_byte_parity_auto_vs_place_false_and_reference(self, store):
        def probed(parse, place):
            pipe = parse(line(n=24), place=place)
            recs = []
            sink = pipe.get("out")
            orig_render = type(sink).render
            orig_hse = type(sink).handle_sink_event

            def render(buf):
                recs.append(("buf", tuple(
                    np.ascontiguousarray(np.asarray(t)).tobytes()
                    for t in buf.as_numpy().tensors)))
                orig_render(sink, buf)

            def hse(pad, event):
                recs.append(("event", event.type.name))
                orig_hse(sink, pad, event)

            sink.render = render
            sink.handle_sink_event = hse
            pipe.run(timeout=60)
            return recs

        got = probed(port, "auto")
        assert got == probed(port, None) == probed(ref, "auto")

    def test_subset_planner_pins_filters_by_global_index(self):
        """A planner over a subset of the cards pins each filter stage by
        its CUDA index (the backend's address space), not its local one;
        a CPU device pins nothing."""
        from nnstreamer_tpu_torch.runtime.placement import _apply, _global_index

        assert _global_index(torch.device("cuda", 3)) == 3
        assert _global_index(torch.device("cpu", 3)) is None
        pipe = port(line())
        pipe._fused_segments = []
        from nnstreamer_tpu_torch.runtime import fusion

        fusion.install(pipe)
        planner = Planner(devices=[torch.device("cuda", 2),
                                   torch.device("cuda", 3)])
        plan = planner.plan(pipe)
        _apply(pipe, plan, planner.devices)
        for st in plan.stages:
            for name in st.elements:
                el = next(e for e in pipe.elements.values()
                          if tprofile.canonical_base(e) == name)
                if el.ELEMENT_NAME == "tensor_filter":
                    assert el._placement_device_index == st.device + 2
        placement.uninstall(pipe)
        assert all(getattr(e, "_placement_device_index", None) is None
                   for e in pipe.elements.values())


# ---------------------------------------------------------------------------
# invalidation / restart / calibration
# ---------------------------------------------------------------------------

class TestReplan:
    def test_fusion_invalidate_marks_plan_dirty_and_replans(self, store):
        pipe = make_artifact(store)
        state = pipe._placement_state
        before = state.snapshot()["replans"]
        pipe.fused_segments[0].invalidate()  # the caps-event path
        assert state._dirty
        state.refresh_if_dirty()
        assert state.snapshot()["replans"] == before + 1
        assert not state._dirty
        assert all(s.device is not None for s in pipe.fused_segments)

    def test_rebuild_refreshes_a_dirty_plan(self, store):
        """_invalidate_fused (where model swaps will call in) drops the
        program; the NEXT build refreshes the plan first."""
        pipe = make_artifact(store)
        state = pipe._placement_state
        before = state.snapshot()["replans"]
        seg = next(s for s in pipe.fused_segments
                   if any(e.ELEMENT_NAME == "tensor_filter"
                          for e in s.elements))
        filt = next(e for e in seg.elements
                    if e.ELEMENT_NAME == "tensor_filter")
        filt._invalidate_fused()
        assert seg._call is None
        seg._build()
        assert state.snapshot()["replans"] == before + 1

    def test_restart_replans_from_scratch(self, store):
        pipe = make_artifact(store)
        state1 = pipe._placement_state
        pipe.play()  # supervised-restart path: stop() already ran
        try:
            state2 = pipe._placement_state
            assert state2 is not state1
            assert all(s.device is not None for s in pipe.fused_segments)
            assert pipe.placement_plan.source == "profile"
        finally:
            pipe.stop()

    def test_calibration_persists_artifact_and_closes_window(self, store):
        pipe = run_placed(line(120))
        assert not tprofile.ACTIVE, "calibration leaked recording"
        assert os.listdir(store)
        snap = pipe._placement_state.snapshot()
        assert snap["source"] == "profile" and not snap["calibrating"]
        assert all(s.stats["dispatches"] >= placement.CALIBRATION_DISPATCHES
                   for s in pipe.fused_segments)

    def test_calibration_move_keeps_a_filter_segment_on_its_backend(
            self, store, monkeypatch):
        """Two injected devices, and the plan that closes calibration
        moves every stage to the other one. A segment holding a filter
        keeps dispatching on the device its backend opened on (its
        weights live there); a transform-only segment follows the plan."""
        from nnstreamer_tpu_torch.runtime import fusion

        two = [torch.device("cpu", 0), torch.device("cpu", 1)]
        monkeypatch.setattr(Planner, "devices",
                            property(lambda self: two))
        plan_fn = Planner.plan

        def plan(self, pipeline, artifact=None):
            p = plan_fn(self, pipeline, artifact=artifact)
            if isinstance(artifact, tprofile.ProfileArtifact):
                now = pipeline._placement_state.plan
                for st in p.stages:
                    st.device = 1 - now.stage_for(st.stage).device
            return p

        monkeypatch.setattr(Planner, "plan", plan)
        homes = []
        run = fusion.FusedSegment._run

        def recording_run(seg, call, args, home):
            weights = [e.backend.device for e in seg.elements
                       if e.ELEMENT_NAME == "tensor_filter"]
            homes.append((seg, seg.device, weights, home))
            return run(seg, call, args, home)

        monkeypatch.setattr(fusion.FusedSegment, "_run", recording_run)
        pipe = run_placed(line(120))
        segs = pipe.fused_segments
        kinds = set()
        for seg in segs:
            pins = [(d, w, h) for s, d, w, h in homes if s is seg]
            assert len(pins) == 120
            assert len({d for d, _, _ in pins}) == 2, "the plan did not move"
            got = [h for _, _, h in pins]
            if pins[0][1]:
                assert set(got) == {pins[0][1][0]}
            else:
                # the old device up to the rebuild after the move (a
                # dispatch already under way keeps it), then the new one
                k = got.index(seg.device)
                assert set(got[:k]) == {pins[0][0]} != {seg.device}
                assert set(got[k:]) == {seg.device}
            kinds.add(bool(pins[0][1]))
        # one segment holds a filter (on its backend's cpu), one does not
        assert kinds == {True, False}
        assert {w[0] for _, _, w, _ in homes if w} == {torch.device("cpu")}

    def test_short_run_closes_window_at_stop(self, store):
        run_placed(line(6))
        assert not tprofile.ACTIVE

    def test_second_run_skips_calibration(self, store):
        run_placed(line(120))
        t0 = time.monotonic()
        pipe = port(line(24), place="auto")
        pipe.play()
        try:
            assert not pipe._placement_state.snapshot()["calibrating"]
            pipe.wait(timeout=60)
        finally:
            pipe.stop()
        assert time.monotonic() - t0 < 30
        assert pipe.placement_plan.source == "profile"


# ---------------------------------------------------------------------------
# queue retune mechanics
# ---------------------------------------------------------------------------

class TestQueueRetune:
    def test_set_capacity_counts_and_applies(self):
        from nnstreamer_tpu_torch.runtime.queue import QueueElement

        q = QueueElement(name="rq", max_size_buffers=4)
        q.set_capacity(8)
        assert q.stats["capacity"] == 8 and q.stats["retuned"] == 1
        q.set_capacity(8)  # unchanged depth is not a retune
        assert q.stats["retuned"] == 1

    @pytest.mark.parametrize("new_capacity", [0, 4])
    def test_raise_unblocks_parked_producer(self, new_capacity):
        """A producer parked on a full bounded channel wakes promptly when
        the planner raises the depth (0 = unbounded), without waiting for
        a worker pop."""
        from nnstreamer_tpu_torch.core import Buffer
        from nnstreamer_tpu_torch.runtime.queue import _Channel

        ch = _Channel(1, "no", name="t")
        ch.put_buf(Buffer([np.zeros(1, np.float32)]))
        unparked = threading.Event()

        def producer():
            ch.put_buf(Buffer([np.zeros(1, np.float32)]))
            unparked.set()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        time.sleep(0.1)
        assert not unparked.is_set()
        ch.set_capacity(new_capacity)
        assert unparked.wait(1.0)
        t.join(1.0)


# ---------------------------------------------------------------------------
# obs surfaces
# ---------------------------------------------------------------------------

class TestObs:
    def test_gauges_and_snapshot(self, store):
        make_artifact(store)
        pipe = port(line(400), place="auto")
        pipe.play()
        try:
            text = tmetrics.render()
            assert "nns_placement_stage_device" in text
            assert f'pipeline="{pipe.name}"' in text
            mine = [s for s in placement.snapshot_all()
                    if s["pipeline"] == pipe.name]
            assert mine and mine[0]["stages"]
        finally:
            pipe.stop()
        # a stopped pipeline's rows leave the scrape immediately
        assert f'pipeline="{pipe.name}"' not in tmetrics.render()
        assert not [s for s in placement.snapshot_all()
                    if s["pipeline"] == pipe.name]

    def test_render_top_placement_section_matches_the_reference(self):
        plan, jplan = _both_plans(ref_artifact())
        snap = dict(plan.to_dict(), replans=0, calibrating=False)
        got = tprofile.render_top({"durations": {}}, [], placement=[snap])
        want = jprofile.render_top({"durations": {}}, [], placement=[snap])
        assert got == want
        assert "PLACEMENT" in got and plan.pipeline in got


# ---------------------------------------------------------------------------
# pinned staging on the CPU (its card behavior: test_torch_fusion_cuda.py)
# ---------------------------------------------------------------------------

def test_stager_on_a_cpu_target_counts_and_retargets():
    s = DoubleBufferedStager(torch.device("cpu"))
    x = np.arange(6, dtype=np.float32)
    (out,) = s.stage([x])
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.numpy().tobytes() == x.tobytes()
    assert s.snapshot() == {"puts": 1, "put_bytes": 24, "depth": 2}
    s.retarget(torch.device("cpu", 1))
    assert s.device == torch.device("cpu", 1)
    with pytest.raises(ValueError):
        DoubleBufferedStager(depth=1)
