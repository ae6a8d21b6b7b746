"""The continuous profiler (obs/profile.py): the port against
nnstreamer_tpu.

Digests, windows (injected clock), artifacts and the ``obs top`` text
are held exactly against the reference on the same seeded samples;
topology hashes and series names of the same launch lines are equal
across the packages (properties are not hashed, so ``framework=torch``
and the port's model paths do not change them); an artifact saved by
either package loads and merges in the other; per-element and
queue-wait attribution over a real run has the reference's series and
counts (the times differ between runs, the counts may not)."""
import json

import numpy as np
import pytest

from nnstreamer_tpu.obs import memory as jmemory
from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.obs import quality as jquality
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu.utils import trace as jtrace
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.obs import memory as tmemory
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.obs import quality as tquality
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.utils import trace

LINE = ("tensor_src name=src num-buffers={n} dimensions=8 types=float32 "
        "! tensor_transform name=t1 mode=arithmetic option=add:1 {acc}"
        "! tensor_transform name=t2 mode=arithmetic option=mul:2 {acc}"
        "! queue name=q ! tensor_sink name=out")
LM_LINE = ("appsrc name=in caps=other/tensors,format=static,"
           "dimensions=6:4,types=int32 ! tensor_filter framework={fw} "
           "{acc}model={pkg}.models.lm_serving:tiny ! tensor_sink name=out")
MB_LINE = ("tensor_src num-buffers=8 dimensions=3:224:224:1 types=uint8 "
           "pattern=random ! tensor_aggregator frames-out=4 ! queue ! "
           "tensor_filter framework={fw} {acc}"
           "model={pkg}.models.mobilenet_v2:filter_model_u8 ! "
           "tensor_decoder mode=image_labeling frames-in=4 ! tensor_sink")


@pytest.fixture(autouse=True)
def _clean_profile():
    before = len(tsan.violations())
    for mod in (tprofile, jprofile):
        mod.stop()
        mod.disable_recording()
        mod.reset()
    yield
    for mod in (tprofile, jprofile):
        mod.stop()
        mod.disable_recording()
        mod.reset()
    trace.uninstall_tracers()
    jtrace.uninstall_tracers()
    assert tsan.violations()[before:] == []


def _port(line, **kw):
    # per-element attribution: both packages unfused (the fused series
    # are held in test_torch_fusion.py)
    return parse_launch(line.format(acc="accelerator=cpu ", fw="torch",
                                    pkg="nnstreamer_tpu_torch", **kw),
                        fuse=False)


def _ref(line, **kw):
    return jax_parse_launch(line.format(acc="", fw="jax",
                                        pkg="nnstreamer_tpu", **kw),
                            fuse=False)


def _samples(dist: str, n: int = 4000) -> list:
    rng = np.random.default_rng(7)
    if dist == "uniform":
        xs = rng.uniform(1e-4, 0.2, n)
    elif dist == "lognormal":
        xs = rng.lognormal(-5.0, 1.2, n)
    else:
        xs = np.concatenate([rng.normal(0.002, 2e-4, n // 2),
                             rng.normal(0.08, 0.01, n // 2)])
    xs = list(np.abs(xs))
    xs += [0.0, 1e-12, 5.0]  # zero bucket and a far outlier
    return [float(x) for x in xs]


# -- digests -------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
@pytest.mark.parametrize("alpha", [0.01, 1.0 / 3.0])
def test_digest_serialization_and_quantiles_match(dist, alpha):
    a, b = tprofile.QuantileDigest(alpha), jprofile.QuantileDigest(alpha)
    for x in _samples(dist):
        a.add(x)
        b.add(x)
    assert a.to_dict() == b.to_dict()
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)
    assert [a.quantile(q) for q in qs] == [b.quantile(q) for q in qs]
    for thr in (0.0, 1e-9, 0.001, 0.01, 0.1, 1.0):
        assert a.count_above(thr) == b.count_above(thr)
    # each package loads the other's serialization into an equal sketch
    assert tprofile.QuantileDigest.from_dict(b.to_dict()) == a
    assert jprofile.QuantileDigest.from_dict(a.to_dict()) == b
    assert repr(a) == repr(b)


def test_digest_merge_equals_pooled_across_packages():
    xs = _samples("lognormal")
    halves = (xs[::2], xs[1::2])
    port = [tprofile.QuantileDigest(0.01) for _ in halves]
    ref = [jprofile.QuantileDigest(0.01) for _ in halves]
    for d, part in zip(port + ref, halves + halves):
        for x in part:
            d.add(x)
    merged = port[0].copy().merge(
        tprofile.QuantileDigest.from_dict(ref[1].to_dict()))
    pooled = tprofile.QuantileDigest(0.01)
    for x in xs:
        pooled.add(x)
    assert merged == pooled
    assert merged.to_dict()["buckets"] == ref[0].copy().merge(
        ref[1]).to_dict()["buckets"]


@pytest.mark.parametrize("bad", [0.0, 0.5, -0.1])
def test_digest_validation_matches(bad):
    msgs = []
    for mod in (tprofile, jprofile):
        with pytest.raises(ValueError) as ei:
            mod.QuantileDigest(bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    for mod in (tprofile, jprofile):
        with pytest.raises(ValueError):
            mod.QuantileDigest(0.01).merge(mod.QuantileDigest(0.02))
        with pytest.raises(ValueError):
            mod.QuantileDigest(0.01).quantile(1.5)


# -- windowed series (injected clock) -------------------------------------------

EVENTS = [(0.01, True, 100.2), (0.02, False, 101.5), (0.5, True, 109.9),
          (0.003, True, 110.0), (0.2, False, 130.7), (0.04, True, 161.0)]


def _series(mod, horizon_s=60.0):
    ws = mod.WindowedSeries(alpha=0.01, horizon_s=horizon_s,
                            resolution_s=1.0)
    for v, ok, t in EVENTS:
        ws.observe(v, ok=ok, now=t)
    return ws


@pytest.mark.parametrize("horizon_s", [4.0, 60.0, 900.0])
@pytest.mark.parametrize("window_s,now", [(1.0, 110.0), (3.0, 110.0),
                                          (15.0, 110.0), (60.0, 161.0),
                                          (300.0, 161.0), (3.0, 400.0)])
def test_windows_match(horizon_s, window_s, now):
    a, b = _series(tprofile, horizon_s), _series(jprofile, horizon_s)
    da, oka, erra = a.window(window_s, now=now)
    db, okb, errb = b.window(window_s, now=now)
    assert (oka, erra) == (okb, errb)
    assert da.to_dict() == db.to_dict()
    assert a.snapshot() == b.snapshot()
    assert a.export_state() == b.export_state()


# -- topology hashes and series names -------------------------------------------

@pytest.mark.parametrize("line", [LM_LINE, MB_LINE, LINE],
                         ids=["lm_filter", "mobilenet_labeling", "chain"])
def test_topology_hash_and_series_names_match(line):
    port, ref = _port(line, n=4), _ref(line, n=4)
    assert tprofile.topology_hash(port) == jprofile.topology_hash(ref)
    assert ([tprofile.series_name(e) for e in port.elements.values()]
            == [jprofile.series_name(e) for e in ref.elements.values()])
    assert ([tprofile.canonical_base(e) for e in port.elements.values()]
            == [jprofile.canonical_base(e) for e in ref.elements.values()])
    # a second parse (fresh auto-name counters) keeps the hash
    assert tprofile.topology_hash(_port(line, n=9)) == \
        tprofile.topology_hash(port)


def test_topology_hash_distinguishes_graphs():
    a = _port(LINE, n=1)
    b = parse_launch("tensor_src name=src num-buffers=1 dimensions=8 "
                     "types=float32 ! tensor_sink name=out")
    assert tprofile.topology_hash(a) != tprofile.topology_hash(b)


# -- attribution over a real run ---------------------------------------------

def _attribution(mod, pipe):
    mod.start()
    pipe.run(timeout=60)
    mod.stop()
    snap = mod.snapshot()
    return {scope: {name: row["count"] for name, row in rows.items()}
            for scope, rows in snap["durations"].items()}


def test_element_and_queue_attribution_match():
    got = _attribution(tprofile, _port(LINE, n=24))
    want = _attribution(jprofile, _ref(LINE, n=24))
    assert got == want
    assert got["element"]["pipeline:t1"] == 24
    assert got["queue_wait"]["pipeline:q"] == 24
    q = tprofile.default_profiler.series("queue_wait", "pipeline:q")
    assert q.depth is not None and q.total_s >= 0


def test_element_attribution_equals_proctime_tracer():
    """The profiler rides the proctime tracer's hook: per-element counts
    and totals agree exactly."""
    tprofile.start()
    golden = trace.install_tracers(["proctime"])[0]
    pipe = _port(LINE, n=20)
    pipe.run(timeout=60)
    tprofile.stop()
    for el, row in golden.results().items():
        s = tprofile.default_profiler.series("element", f"{pipe.name}:{el}")
        assert s.count == row["buffers"]
        assert abs(s.total_s - row["total_s"]) < 1e-9


def test_disabled_profiler_records_nothing():
    pipe = _port(LINE, n=5)
    pipe.run(timeout=30)
    snap = tprofile.snapshot()
    assert not snap["active"] and not snap["durations"] \
        and not snap["requests"]
    assert trace.ACTIVE is False


def test_queue_stamp_never_leaks_downstream():
    seen = []
    tprofile.start()
    pipe = _port(LINE, n=6)
    pipe.get("out").connect(lambda b: seen.append(dict(b.meta)))
    pipe.run(timeout=30)
    assert len(seen) == 6
    assert not any("_prof_q_t0" in m for m in seen)


# -- artifacts -----------------------------------------------------------------

def _synthetic_profiler(mod, pipe_name):
    prof = mod.Profiler()
    rng = np.random.default_rng(3)
    for name in ("src", "t1", "t2", "q", "out"):
        for v in rng.lognormal(-7, 0.5, 50):
            prof.observe("element", f"{pipe_name}:{name}", float(v))
    for v in rng.lognormal(-8, 0.3, 50):
        prof.observe("queue_wait", f"{pipe_name}:q", float(v), depth=3)
    prof.observe("serving", "batch:x", 0.01)  # not a pipeline scope
    prof.record_request("serving:x", 0.02, now=5.0)
    return prof


def _capture(mod, pipe, model_version="v1"):
    return mod.ProfileArtifact.capture(
        pipe, model_version=model_version,
        profiler=_synthetic_profiler(mod, pipe.name))


def _json_without_created(art) -> dict:
    d = art.to_dict()
    d.pop("created")
    return d


@pytest.fixture
def empty_accountants():
    for mod in (tmemory, jmemory, tquality, jquality):
        mod.reset()
    yield
    for mod in (tmemory, jmemory, tquality, jquality):
        mod.reset()


def test_artifact_json_matches(empty_accountants):
    port = _capture(tprofile, _port(LINE, n=4))
    ref = _capture(jprofile, _ref(LINE, n=4))
    assert port.key == ref.key
    assert _json_without_created(port) == _json_without_created(ref)
    assert port.summary() == ref.summary()
    # the serving/request series are not topology-shaped: not captured
    assert set(port.entries) == {"element", "queue_wait"}


def test_artifacts_cross_load_and_merge(tmp_path, empty_accountants):
    port = _capture(tprofile, _port(LINE, n=4))
    ref = _capture(jprofile, _ref(LINE, n=4))
    p_port, p_ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    port.save(p_port)
    ref.save(p_ref)
    # the reference loads and merges the port's file, and vice versa
    j_merged = jprofile.ProfileArtifact.load(p_ref).merge(
        jprofile.ProfileArtifact.load(p_port))
    t_merged = tprofile.ProfileArtifact.load(p_port).merge(
        tprofile.ProfileArtifact.load(p_ref))
    assert _json_without_created(t_merged) == _json_without_created(j_merged)
    assert t_merged.entries["element"]["t1"]["count"] == 100
    pooled = port.entries["element"]["t1"]["digest"].copy().merge(
        tprofile.QuantileDigest.from_dict(
            ref.entries["element"]["t1"]["digest"].to_dict()))
    assert t_merged.entries["element"]["t1"]["digest"] == pooled


def test_artifact_merge_rejects_different_key():
    a = tprofile.ProfileArtifact({"topology": "x", "model_version": "1"}, {})
    b = tprofile.ProfileArtifact({"topology": "y", "model_version": "1"}, {})
    with pytest.raises(ValueError, match="different keys"):
        a.merge(b)
    with pytest.raises(ValueError, match="not a profile artifact"):
        tprofile.ProfileArtifact.from_dict({"kind": "other"})


def test_artifact_diff_matches():
    key = {"topology": "t", "caps": "c", "model_version": "v1"}

    def arts(mod):
        d1, d2 = mod.QuantileDigest(0.01), mod.QuantileDigest(0.01)
        for _ in range(100):
            d1.add(0.010)
            d2.add(0.020)
        a = mod.ProfileArtifact(key, {"fused": {"s": {
            "count": 100, "total_s": 1.0, "digest": d1}}})
        b = mod.ProfileArtifact({**key, "model_version": "v2"}, {
            "fused": {"s": {"count": 100, "total_s": 2.0, "digest": d2}},
            "element": {"only_b": {"count": 1, "total_s": 0.1,
                                   "digest": d2.copy()}}})
        return a.diff(b)

    assert arts(tprofile) == arts(jprofile)
    assert arts(tprofile)["fused"]["s"]["delta_p50_ms"] == pytest.approx(
        10.0, rel=0.05)


def test_store_accumulates_and_prunes_like_the_reference(tmp_path,
                                                          monkeypatch):
    key = {"topology": "abc", "caps": "c", "model_version": "v"}

    def fill(mod, root):
        d = mod.QuantileDigest(0.01)
        d.add(0.01)
        store = mod.ProfileStore(str(root))
        for n in (1, 2):
            store.save(mod.ProfileArtifact(key, {"element": {"e": {
                "count": n, "total_s": 0.01 * n, "digest": d.copy()}}}))
        return store

    t, j = fill(tprofile, tmp_path / "t"), fill(jprofile, tmp_path / "j")
    assert t.load(key).entries["element"]["e"]["count"] == 3
    assert [r["topology"] for r in t.list()] == \
        [r["topology"] for r in j.list()] == ["abc"]
    assert t.path_for(key).rsplit("/", 1)[1] == \
        j.path_for(key).rsplit("/", 1)[1]
    # the reference's store reads the port's file
    assert jprofile.ProfileStore(str(tmp_path / "t")).load(key) \
        .entries["element"]["e"]["count"] == 3
    assert t.load({**key, "topology": "zzz"}) is None
    for i in range(3):
        t.save(tprofile.ProfileArtifact({**key, "topology": f"k{i}"}, {}))
    assert len(t.prune(2)) == 2 and len(t.list()) == 2
    monkeypatch.setenv(tprofile.STORE_ENV, str(tmp_path / "env"))
    monkeypatch.setenv(tprofile.STORE_MAX_ENV, "5")
    assert tprofile.default_store().max_artifacts == 5
    monkeypatch.delenv(tprofile.STORE_ENV)
    assert tprofile.default_store() is None


# -- request series ----------------------------------------------------------

def test_scheduler_request_series_match():
    from nnstreamer_tpu.serving import Scheduler as JScheduler
    from nnstreamer_tpu_torch.serving import Scheduler

    counts = []
    for mod, cls in ((tprofile, Scheduler), (jprofile, JScheduler)):
        mod.enable_recording()
        sched = cls(lambda x: x + 1, bucket_sizes=(1, 2), max_wait_s=0.001,
                    name="prof-sched")
        try:
            for _ in range(4):
                sched([np.ones((1, 4), np.float32)], timeout=30.0)
        finally:
            sched.close()
        mod.disable_recording()
        snap = mod.default_profiler.request_series(
            f"serving:{sched.name}").snapshot()
        counts.append((snap["count"], snap["errors"]))
    assert counts[0] == counts[1] == (4, 0)


def test_failed_requests_count_as_errors():
    from nnstreamer_tpu_torch.serving import Scheduler
    from nnstreamer_tpu_torch.serving.request import ServingError

    class _Boom:
        compiles = 0

        def __call__(self, *xs):
            raise RuntimeError("backend on fire")

    tprofile.enable_recording()
    sched = Scheduler(executor=_Boom(), bucket_sizes=(1,), max_wait_s=0.001,
                      name="prof-boom")
    try:
        with pytest.raises(ServingError):
            sched([np.ones((1, 4), np.float32)], timeout=30.0)
    finally:
        sched.close()
    ws = tprofile.default_profiler.request_series("serving:prof-boom")
    assert ws.snapshot()["errors"] == 1


def test_recording_halves_are_independent():
    """stop() ending a capture must not silence an engine's recording,
    and calibrations are refcounted."""
    tprofile.start()
    tprofile.enable_recording()
    tprofile.stop()
    assert tprofile.ACTIVE
    tprofile.disable_recording()
    assert not tprofile.ACTIVE
    tprofile.begin_calibration()
    tprofile.begin_calibration()
    tprofile.end_calibration()
    assert tprofile.ACTIVE
    tprofile.end_calibration()
    assert not tprofile.ACTIVE


# -- surfaces -----------------------------------------------------------------

def _top_inputs(mod, qmod):
    prof = _synthetic_profiler(mod, "p")
    prof.record_request("serving:svc", 0.05, ok=False, now=10.0)
    snap = prof.snapshot()
    snap["active"] = True
    for rows in snap["durations"].values():
        for row in rows.values():
            row["rate_hz"] = 100.0  # a wall-clock rate: pinned for both
    slo = [{"name": "lat", "target": 0.99, "alerting": True,
            "windows": [{"short_s": 60.0, "long_s": 300.0,
                         "burn_short": 15.5, "burn_long": 20.25}]}]
    memory = {"devices": [{"device": "cuda:0", "bytes_in_use": 3 << 30,
                           "peak_bytes": 4 << 30, "budget_bytes": 80 << 30,
                           "used_fraction": 3 / 80}],
              "stages": {"p:f": {"total_bytes": 12345678,
                                 "param_bytes": 10000000,
                                 "temp_bytes": 2345678}},
              "queues": {"p": {"q": {"depth": 2, "frame_bytes": 4096,
                                     "bytes": 8192}}},
              "serving": {"kv": {"bytes": 1 << 20, "peak_bytes": 2 << 20,
                                 "pages_total": 64, "pages_used": 16,
                                 "pages_shared": 3}}}
    acc = qmod.QualityAccountant()
    acc.observe("p:out", [np.arange(-8, 8, dtype=np.float32)])
    quality = {"active": True, "sample_every": 8,
               "stages": acc.snapshots(), "drift": {"p:out": 0.125}}
    transport = {"negotiated": {"nnsb": 2}, "connections": {"nnsb": 1},
                 "frames": {"nnsb:tx": 10}, "bytes": {"nnsb:tx": 2 << 20}}
    placement = [{"pipeline": "p", "source": "store",
                  "balance": {"max_stage_ms": 1.5, "target_ms": 1.25},
                  "stages": [{"stage": "f", "device": 0, "cost_ms": 1.5}],
                  "queues": {"q": {"depth": 4, "wait_p99_ms": 0.5}}}]
    return snap, slo, memory, quality, transport, placement


def test_render_top_matches():
    snap, slo, mem, q, tr, pl = _top_inputs(tprofile, tquality)
    got = tprofile.render_top(snap, slo, placement=pl, memory=mem,
                              quality=q, transport=tr)
    jsnap, jslo, jmem, jq, jtr, jpl = _top_inputs(jprofile, jquality)
    want = jprofile.render_top(jsnap, jslo, placement=jpl, memory=jmem,
                               quality=jq, transport=jtr)
    assert got == want
    for section in ("ELEMENTS", "QUEUE WAIT", "REQUESTS", "SLO",
                    "MEMORY (devices)", "QUALITY", "TRANSPORT", "PLACEMENT"):
        assert section in got


def test_snapshot_export_and_histograms():
    tprofile.start()
    pipe = _port(LINE, n=4)
    pipe.run(timeout=30)
    tprofile.record_request("serving:r", 0.01)
    state = tprofile.export_state()
    json.dumps(state)
    assert state["durations"]["element"]["pipeline:t1"]["count"] == 4
    assert state["requests"]["serving:r"]["total"]["count"] == 1
    text = tmetrics.render()
    assert 'nns_profile_stage_seconds_count{scope="element",' \
           'stage="pipeline:t1"}' in text
    assert "nns_profile_request_seconds" in text
    assert "nns_flight_events_total" in text
