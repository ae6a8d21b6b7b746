"""The port's fleet view (``nnstreamer_tpu_torch/obs/fleet.py``) against
nnstreamer_tpu's, on the CPU.

* merge exactness: the port's ``QuantileDigest`` merge of two replicas'
  samples equals the reference's merge of the same samples, bucket for
  bucket, and both equal the pooled digest;
* ``render_top``'s FLEET and AUTOSCALER sections are byte-equal to the
  reference's on the same snapshots;
* the cases of the reference's ``tests/test_fleet.py`` on the port: the
  fleet key, merged digests/durations/windows/memory/quality, the scrape
  lifecycle (static and source endpoints, a replica dying mid-scrape,
  membership changes, the tick thread), the merged flight stream with its
  cursors, the SLO engine and autoscaler reading the fleet, the fleet
  gauges and routes, ``obs fleet``, and the cross-process trace stitch
  over two subprocess replicas."""
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

import nnstreamer_tpu.obs.profile as r_profile
from nnstreamer_tpu_torch.obs import context as obs_ctx
from nnstreamer_tpu_torch.obs import fleet as obs_fleet
from nnstreamer_tpu_torch.obs import flight as obs_flight
from nnstreamer_tpu_torch.obs import metrics as obs_metrics
from nnstreamer_tpu_torch.obs import profile as obs_profile
from nnstreamer_tpu_torch.obs import promtext
from nnstreamer_tpu_torch.obs.fleet import (PARENT_REPLICA, FleetError,
                                             FleetView)
from nnstreamer_tpu_torch.obs.profile import Profiler, QuantileDigest
from nnstreamer_tpu_torch.obs.quality import TensorHealth
from nnstreamer_tpu_torch.obs.slo import SLObjective, SloEngine

CAPS = "other/tensors,format=static,dimensions=4,types=float32"

pytestmark = pytest.mark.timeout_s(60)


@pytest.fixture(autouse=True)
def _clean_obs():
    yield
    obs_ctx.disable_tracing()
    obs_ctx.reset()
    obs_profile.disable_recording()
    obs_profile.reset()


class StubReplica:
    """Serves the fleet-scrape routes (/profile?raw=1, /memory,
    /quality?raw=1, /metrics, /flight, /spans) from canned per-instance
    state. Each instance owns an independent Profiler — exactly the
    process-isolation the fleet merge exists to bridge."""

    def __init__(self):
        self.profiler = Profiler()
        self.memory = {"stages": {}, "devices": []}
        self.quality_cells = {}
        self.metrics_text = ""
        self.flight_events = []  # full dicts incl. seq/time
        self.flight_pid = 7      # bump to simulate a respawn
        self.spans = []
        self.fail = False  # arm to simulate a dying replica
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def do_GET(self):
                if stub.fail:
                    self.send_error(500, "chaos")
                    return
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                if u.path == "/metrics":
                    body = stub.metrics_text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if u.path == "/profile":
                    doc = {"profile": {}, "slo": []}
                    if q.get("raw") in ("1", "true"):
                        doc["raw"] = stub.profiler.export_state()
                elif u.path == "/memory":
                    doc = {"memory": stub.memory}
                elif u.path == "/quality":
                    doc = {"quality": {}}
                    if q.get("raw") in ("1", "true"):
                        doc["cells"] = stub.quality_cells
                elif u.path == "/flight":
                    after = q.get("after")
                    after = None if after is None else int(after)
                    evs = [e for e in stub.flight_events
                           if after is None or e["seq"] > after]
                    doc = {"pid": stub.flight_pid,
                           "events": evs[-int(q.get("last", 256)):]}
                elif u.path == "/spans":
                    spans = stub.spans
                    if q.get("trace"):
                        spans = [s for s in spans
                                 if s["trace_id"] == q["trace"]]
                    doc = {"pid": 99, "mono_to_wall": 0.0, "spans": spans}
                else:
                    self.send_error(404)
                    return
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.endpoint = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="stubreplica", daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


@pytest.fixture
def stubs():
    reps = [StubReplica(), StubReplica()]
    yield reps
    for r in reps:
        r.stop()


def _view(endpoints, **kw):
    kw.setdefault("include_parent_flight", False)
    return FleetView("t", endpoints=endpoints, **kw)




def test_digest_merge_equals_the_reference():
    """Two replicas' samples, merged bucket-wise by the port's digest and
    by the reference's: the same buckets, counts and extremes, the same
    quantiles, and both the pooled digest."""
    rng = np.random.default_rng(13)
    a = rng.lognormal(-4.0, 1.0, 400)
    b = rng.lognormal(-3.0, 0.5, 300)
    out = []
    for cls in (QuantileDigest, r_profile.QuantileDigest):
        da, db, pooled = cls(), cls(), cls()
        for v in a:
            da.add(float(v))
        for v in b:
            db.add(float(v))
        for v in np.concatenate([a, b]):
            pooled.add(float(v))
        # through the wire form each replica exports
        merged = cls.from_dict(json.loads(json.dumps(da.to_dict())))
        merged.merge(cls.from_dict(json.loads(json.dumps(db.to_dict()))))
        md, pd = merged.to_dict(), pooled.to_dict()
        assert md.pop("sum") == pytest.approx(pd.pop("sum"))
        assert md == pd
        out.append((merged.to_dict(),
                    [merged.quantile(q) for q in (0.5, 0.9, 0.99)]))
    assert out[0] == out[1]


def test_render_top_fleet_and_autoscaler_sections_equal_the_reference(
        stubs):
    r1, r2 = stubs
    for k in range(40):
        r1.profiler.record_request("serving:query", 0.001 * (k + 1))
        r2.profiler.record_request("serving:query", 0.002 * (k + 1),
                                   ok=k % 7 != 0)
    r1.metrics_text = ('nns_wire_frames_total{format="shm",direction="tx"} '
                       '12\n')
    v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
    try:
        v.tick()
        fleet = json.loads(json.dumps(obs_fleet.snapshot_all(),
                                      default=str))
    finally:
        v.stop()
    autoscale = [{"name": "pool-a", "replicas": 2, "desired_replicas": 3,
                  "min_replicas": 1, "max_replicas": 4, "shed_armed": True,
                  "scale_out": 3, "scale_in": 1, "blocked_by_memory": 2,
                  "respawns": 1, "respawn_gave_up": 0,
                  "last_decision": {"action": "scale_out",
                                    "burn_short": 4.25, "burn_long": 1.5,
                                    "samples_short": 31,
                                    "memory_used_fraction": 0.4125,
                                    "out_cooldown_s": 2.5,
                                    "in_cooldown_s": 12.0}},
                 {"name": "pool-b"}]
    snap = {"active": True, "durations": {}}
    got = obs_profile.render_top(snap, [], fleet=fleet, autoscale=autoscale)
    want = r_profile.render_top(snap, [], fleet=fleet, autoscale=autoscale)
    assert got == want
    assert "FLEET [t]" in got and "AUTOSCALER [pool-a]" in got


class TestFleetKey:
    def test_pipeline_prefix_stripped(self):
        assert obs_fleet.fleet_key("pipe7:filter@2") == "filter@2"

    def test_deployment_heads_kept(self):
        assert obs_fleet.fleet_key("serving:query") == "serving:query"
        assert obs_fleet.fleet_key("fabric:pool0") == "fabric:pool0"

    def test_bare_names_unchanged(self):
        assert obs_fleet.fleet_key("plain") == "plain"


# ---------------------------------------------------------------------------
# merge exactness: the tentpole property
# ---------------------------------------------------------------------------

class TestMergeExactness:
    def test_request_digest_merge_is_pooled_digest(self, stubs):
        r1, r2 = stubs
        rng = np.random.default_rng(13)
        a = rng.lognormal(-4.0, 1.0, 400)
        b = rng.lognormal(-3.0, 0.5, 300)
        for v in a:
            r1.profiler.record_request("serving:query", float(v))
        for v in b:
            r2.profiler.record_request("serving:query", float(v))
        pooled = QuantileDigest()
        for v in np.concatenate([a, b]):
            pooled.add(float(v))
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            assert v.tick() == {"r1": "ok", "r2": "ok"}
            merged = v.request_total("serving:query")
            # EXACT: same buckets/counts/extremes — not approximately-
            # equal quantiles. (The running `sum` differs only by float
            # addition order across the two accumulation histories.)
            md, pd = merged.to_dict(), pooled.to_dict()
            assert md.pop("sum") == pytest.approx(pd.pop("sum"))
            assert md == pd
            for q in (0.5, 0.9, 0.99):
                assert merged.quantile(q) == pooled.quantile(q)
            assert merged.count == 700
        finally:
            v.stop()

    def test_duration_merge_lines_up_replica_pipelines(self, stubs):
        r1, r2 = stubs
        # replicas of one launch line have DIFFERENT pipeline names;
        # the fleet key strips them so the same stage pools
        for v_ in (0.01, 0.02):
            r1.profiler.observe("fused", "pipe_a:seg0", v_)
        for v_ in (0.03, 0.04):
            r2.profiler.observe("fused", "pipe_b:seg0", v_)
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            v.tick()
            fused = v.merged_durations()["fused"]
            assert list(fused) == ["seg0"]
            cell = fused["seg0"]
            assert cell["count"] == 4
            assert sorted(cell["replicas"]) == ["r1", "r2"]
            pooled = QuantileDigest()
            for s in (0.01, 0.02, 0.03, 0.04):
                pooled.add(s)
            assert cell["digest"].to_dict() == pooled.to_dict()
        finally:
            v.stop()

    def test_window_merge_counts_and_fallback(self, stubs):
        r1, r2 = stubs
        r1.profiler.record_request("serving:query", 0.01, ok=True)
        r1.profiler.record_request("serving:query", 0.20, ok=False)
        r2.profiler.record_request("serving:query", 0.02, ok=True)
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            v.tick()
            digest, ok, err = v.request_window("serving:query", 60.0)
            assert (ok, err) == (2, 1)
            assert digest.count == 3
            # a series NO replica exports falls back to the local
            # profiler (availability/memory self-sampled series)
            obs_profile.enable_recording()
            obs_profile.default_profiler.record_request(
                "availability:svc", 0.0, ok=False)
            _d, ok2, err2 = v.request_window("availability:svc", 60.0)
            assert (ok2, err2) == (0, 1)
        finally:
            v.stop()

    def test_memory_merges_max_watermark(self, stubs):
        r1, r2 = stubs
        r1.memory = {
            "stages": {"pipe_a:seg0": {"kind": "fused", "temp_bytes": 100,
                                       "output_bytes": 10}},
            "devices": [{"device": "cpu:0", "bytes_in_use": 50,
                         "peak_bytes": 80}],
        }
        r2.memory = {
            "stages": {"pipe_b:seg0": {"kind": "fused", "temp_bytes": 70,
                                       "output_bytes": 40}},
            "devices": [{"device": "cpu:0", "bytes_in_use": 60,
                         "peak_bytes": 75}],
        }
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            v.tick()
            mem = v.merged_memory()
            seg = mem["stages"]["seg0"]
            # per-field MAX, never a sum
            assert seg["temp_bytes"] == 100
            assert seg["output_bytes"] == 40
            dev = mem["devices"][0]
            assert dev["bytes_in_use"] == 60
            assert dev["peak_bytes"] == 80
        finally:
            v.stop()

    def test_quality_merges_additively(self, stubs):
        r1, r2 = stubs

        def cell(nan, elems):
            h = TensorHealth()
            h.buffers, h.elems, h.nan = 1, elems, nan
            h.finite = elems - nan
            h.sum = float(h.finite)
            h.sumsq = float(h.finite)
            h.min, h.max = 1.0, 1.0
            h.hist.add(1.0, h.finite)
            return h.to_cell()

        r1.quality_cells = {"pipe_a:tap0": cell(2, 100)}
        r2.quality_cells = {"pipe_b:tap0": cell(3, 200)}
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            v.tick()
            merged = v.merged_quality()["tap0"]
            h = TensorHealth.from_cell(merged)
            assert h.elems == 300
            assert h.nan == 5
            assert h.hist.count == 295
        finally:
            v.stop()


# ---------------------------------------------------------------------------
# scrape lifecycle: discovery, staleness, chaos coherence
# ---------------------------------------------------------------------------

class TestScrapeLifecycle:
    def test_config_validation(self):
        with pytest.raises(FleetError):
            FleetView("bad", endpoints={}, tick_s=0.0)
        with pytest.raises(FleetError):
            FleetView("bad", endpoints={}, stale_after_s=0.0)
        with pytest.raises(FleetError):
            FleetView("bad")  # neither source nor endpoints

    def test_source_and_static_endpoints_compose(self, stubs):
        r1, r2 = stubs

        class Source:
            def control_endpoints(self):
                return {"dyn": r1.endpoint}

        v = FleetView("t", source=Source(),
                      endpoints={"static": r2.endpoint},
                      include_parent_flight=False)
        try:
            out = v.tick()
            assert set(out) == {"dyn", "static"}
            assert all(o == "ok" for o in out.values())
        finally:
            v.stop()

    def test_kill_one_replica_mid_scrape_snapshot_stays_coherent(
            self, stubs):
        r1, r2 = stubs
        r1.profiler.record_request("serving:query", 0.01)
        r2.profiler.record_request("serving:query", 0.02)
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint},
                  stale_after_s=0.05)
        try:
            v.tick()
            assert v.request_total("serving:query").count == 2
            r2.fail = True  # chaos: replica starts erroring mid-scrape
            time.sleep(0.06)
            out = v.tick()
            assert out == {"r1": "ok", "r2": "error"}
            snap = v.snapshot()
            rows = {r["replica"]: r for r in snap["replicas"]}
            assert rows["r1"]["ok"] and not rows["r1"]["stale"]
            assert not rows["r2"]["ok"]
            assert rows["r2"]["stale"]
            assert rows["r2"]["errors"] >= 1
            assert rows["r2"]["last_error"]
            # the dead replica's LAST-KNOWN data still merges — bounded
            # staleness, not amnesia
            assert v.request_total("serving:query").count == 2
        finally:
            v.stop()

    def test_no_endpoint_membership_reported_not_scraped(self, stubs):
        r1, _ = stubs
        eps = {"r1": r1.endpoint, "dead": None}
        v = _view(lambda: eps)
        try:
            out = v.tick()
            assert out == {"r1": "ok", "dead": "no-endpoint"}
            rows = {r["replica"]: r for r in v.replicas()}
            assert rows["dead"]["stale"]
            assert "no control endpoint" in rows["dead"]["last_error"]
        finally:
            v.stop()

    def test_membership_removal_forgets_replica(self, stubs):
        r1, r2 = stubs
        eps = {"r1": r1.endpoint, "r2": r2.endpoint}
        v = _view(lambda: dict(eps))
        try:
            v.tick()
            assert len(v.replicas()) == 2
            del eps["r2"]  # scale-in / breaker discard
            v.tick()
            assert [r["replica"] for r in v.replicas()] == ["r1"]
        finally:
            v.stop()

    def test_tick_thread_lifecycle_joins(self, stubs):
        r1, _ = stubs
        v = _view({"r1": r1.endpoint}, tick_s=0.05)
        v.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and v._ticks == 0:
            time.sleep(0.02)
        assert v._ticks > 0
        v.stop()  # conftest's fleet: prefix check catches a leak

    def test_restarted_view_rejoins_surfaces(self, stubs):
        """stop() leaves the scrape surfaces (gauges, /fleet, CLI);
        start() must re-join them — same stance as Autoscaler.start()
        — or a restarted view keeps scraping invisibly."""
        r1, _ = stubs
        v = _view({"r1": r1.endpoint}, tick_s=0.05)
        v.start()
        assert v in obs_fleet.views()
        v.stop()
        assert v not in obs_fleet.views()
        v.start()
        try:
            assert v in obs_fleet.views()
        finally:
            v.stop()


# ---------------------------------------------------------------------------
# merged flight stream
# ---------------------------------------------------------------------------

class TestMergedFlight:
    def test_interleave_by_timestamp_with_replica_tags(self, stubs):
        r1, r2 = stubs
        t0 = time.time()
        r1.flight_events = [
            {"seq": 0, "time": t0 + 0.1, "kind": "fabric", "name": "b",
             "data": {}, "pipeline": None},
            {"seq": 1, "time": t0 + 0.3, "kind": "fabric", "name": "d",
             "data": {}, "pipeline": None},
        ]
        r2.flight_events = [
            {"seq": 0, "time": t0 + 0.0, "kind": "serving", "name": "a",
             "data": {}, "pipeline": "p"},
            {"seq": 1, "time": t0 + 0.2, "kind": "serving", "name": "c",
             "data": {}, "pipeline": "p"},
        ]
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            v.tick()
            evs = v.flight()
            assert [e["name"] for e in evs] == ["a", "b", "c", "d"]
            assert [e["replica"] for e in evs] == ["r2", "r1", "r2", "r1"]
            seqs = [e["fleet_seq"] for e in evs]
            assert seqs == sorted(seqs)
            # filters compose on the merged stream
            assert [e["name"] for e in v.flight(category="serving")] \
                == ["a", "c"]
            assert [e["name"] for e in v.flight(pipeline="p")] == ["a", "c"]
        finally:
            v.stop()

    def test_cursor_pulls_each_event_exactly_once(self, stubs):
        r1, _ = stubs
        t0 = time.time()
        r1.flight_events = [
            {"seq": 0, "time": t0, "kind": "k", "name": "a", "data": {},
             "pipeline": None}]
        v = _view({"r1": r1.endpoint})
        try:
            v.tick()
            first = v.flight()
            assert [e["name"] for e in first] == ["a"]
            cursor = first[-1]["fleet_seq"]
            assert v.flight(after=cursor) == []
            r1.flight_events.append(
                {"seq": 1, "time": t0 + 1.0, "kind": "k", "name": "b",
                 "data": {}, "pipeline": None})
            v.tick()
            fresh = v.flight(after=cursor)
            assert [e["name"] for e in fresh] == ["b"]
            # the per-replica scrape cursor advanced too: "a" was not
            # re-pulled (would have duplicated into the ring)
            assert len(v.flight()) == 2
        finally:
            v.stop()

    def test_cursored_pull_is_uncapped_burst_not_lost(self, stubs):
        """flight_pull bounds only the FIRST (cursorless) backlog pull;
        a cursored pull fetches uncapped — the cursor advances to the
        newest seq regardless, so a cap below a burst would drop its
        oldest events from the merged stream forever."""
        r1, _ = stubs
        t0 = time.time()
        r1.flight_events = [
            {"seq": i, "time": t0 + i * 0.01, "kind": "k", "name": f"b{i}",
             "data": {}, "pipeline": None} for i in range(6)]
        v = _view({"r1": r1.endpoint}, flight_pull=4)
        try:
            v.tick()
            # initial backlog IS capped: newest 4 of the 6
            assert [e["name"] for e in v.flight()] == [
                "b2", "b3", "b4", "b5"]
            # a burst wider than flight_pull between ticks
            r1.flight_events += [
                {"seq": 6 + i, "time": t0 + 1.0 + i * 0.01, "kind": "k",
                 "name": f"c{i}", "data": {}, "pipeline": None}
                for i in range(10)]
            v.tick()
            names = [e["name"] for e in v.flight()]
            assert names[-10:] == [f"c{i}" for i in range(10)]
        finally:
            v.stop()

    def test_respawn_resets_flight_cursor(self, stubs):
        """A respawned replica's recorder restarts at seq 0; the stale
        high cursor must reset (pid change) or every post-respawn event
        — the postmortem ones — would be silently filtered out."""
        r1, _ = stubs
        t0 = time.time()
        r1.flight_events = [
            {"seq": 41, "time": t0, "kind": "k", "name": "old", "data": {},
             "pipeline": None}]
        v = _view({"r1": r1.endpoint})
        try:
            v.tick()
            assert [e["name"] for e in v.flight()] == ["old"]
            # respawn: new process, fresh recorder, low seqs again
            r1.flight_pid = 8
            r1.flight_events = [
                {"seq": 0, "time": t0 + 1.0, "kind": "k", "name": "fresh",
                 "data": {}, "pipeline": None}]
            v.tick()
            assert [e["name"] for e in v.flight()] == ["old", "fresh"]
        finally:
            v.stop()

    def test_parent_events_join_the_merged_stream(self, stubs):
        r1, _ = stubs
        v = FleetView("t", endpoints={"r1": r1.endpoint},
                      include_parent_flight=True)
        try:
            obs_flight.record("fleettest", "parent-ev", {})
            v.tick()
            mine = [e for e in v.flight() if e["kind"] == "fleettest"]
            assert mine and mine[-1]["replica"] == PARENT_REPLICA
        finally:
            v.stop()


# ---------------------------------------------------------------------------
# query-server serve attribution (the child half of the stitch)
# ---------------------------------------------------------------------------

class TestFleetFacade:
    def test_slo_burn_over_fleet_merged_window(self, stubs):
        r1, r2 = stubs
        # every sample breaches the 50 ms objective, split across two
        # replica-private recorders — only the MERGE sees them all
        for _ in range(30):
            r1.profiler.record_request("serving:query", 0.2)
            r2.profiler.record_request("serving:query", 0.3)
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        engine = SloEngine(profiler=v, name="fleettest")
        engine.add(SLObjective(name="fleet-p99", kind="latency",
                               series="serving:query", target=0.9,
                               threshold_s=0.05,
                               windows=((60.0, 120.0, 1.0),)))
        try:
            v.tick()
            status = engine.evaluate()
            assert status[0]["alerting"]
            assert status[0]["windows"][0]["burn_short"] > 1.0
        finally:
            engine.stop()
            v.stop()

    def test_autoscaler_fleet_source(self, stubs):
        from nnstreamer_tpu_torch.service import Autoscaler, AutoscalerConfig

        r1, _ = stubs

        class Target:
            class pool:
                name = "p"

            def replica_count(self):
                return 1

        v = _view({"r1": r1.endpoint})
        try:
            with pytest.raises(ValueError):
                Autoscaler(Target(), AutoscalerConfig(), fleet=v,
                           profiler=obs_profile.default_profiler)
            sc = Autoscaler(Target(), AutoscalerConfig(),
                            series="serving:query", fleet=v)
            assert sc.snapshot()["source"] == "fleet:t"
            assert sc._profiler is v
            # fleet= defaults to the replicas' serve series: the local
            # default "fabric:<pool>" is parent-only, so the fleet read
            # would silently fall back to the local recorder
            assert Autoscaler(Target(), AutoscalerConfig(),
                              fleet=v).series == "serving:query"
            assert Autoscaler(Target(),
                              AutoscalerConfig()).series == "fabric:p"
        finally:
            v.stop()


# ---------------------------------------------------------------------------
# gauges + obs top section
# ---------------------------------------------------------------------------

class TestGaugesAndTop:
    def test_fleet_gauges_rendered_and_cleared_at_stop(self, stubs):
        r1, r2 = stubs
        r1.profiler.record_request("serving:query", 0.01)
        r2.profiler.record_request("serving:query", 0.03)
        v = _view({"r1": r1.endpoint, "r2": r2.endpoint})
        try:
            v.tick()
            text = obs_metrics.render()
            assert promtext.sample(text, "nns_fleet_replicas",
                                   fleet="t") == 2.0
            assert promtext.sample(text, "nns_fleet_replica_up",
                                   fleet="t", replica="r1") == 1.0
            assert promtext.sample(text, "nns_fleet_scrapes_total",
                                   fleet="t", replica="r2") == 1.0
            assert promtext.sample(
                text, "nns_fleet_request_count",
                fleet="t", series="serving:query") == 2.0
            p99 = promtext.sample(text, "nns_fleet_request_p99_seconds",
                                  fleet="t", series="serving:query")
            assert p99 is not None and p99 > 0.0
            r1p = promtext.sample(
                text, "nns_fleet_replica_request_p99_seconds",
                fleet="t", replica="r1", series="serving:query")
            assert r1p is not None
        finally:
            v.stop()
        # stopped views leave the scrape (unregister-at-stop stance)
        assert promtext.sample(obs_metrics.render(),
                               "nns_fleet_replicas", fleet="t") is None

    def test_top_fleet_section(self, stubs):
        r1, _ = stubs
        r1.profiler.record_request("serving:query", 0.01)
        v = _view({"r1": r1.endpoint})
        try:
            v.tick()
            text = obs_profile.render_top(
                obs_profile.snapshot(), [], fleet=obs_fleet.snapshot_all())
            assert "FLEET [t]" in text
            assert "r1" in text
            assert "serving:query" in text
        finally:
            v.stop()


# ---------------------------------------------------------------------------
# control-plane routes + CLI
# ---------------------------------------------------------------------------

class TestRoutesAndCli:
    @pytest.fixture
    def server(self):
        from nnstreamer_tpu_torch.service import (ControlClient, ControlServer,
                                            ServiceManager)

        mgr = ServiceManager()
        srv = ControlServer(mgr).start()
        yield ControlClient(f"http://127.0.0.1:{srv.port}")
        srv.stop()
        mgr.shutdown()

    def test_fleet_route_and_client(self, stubs, server):
        r1, _ = stubs
        v = _view({"r1": r1.endpoint})
        try:
            v.tick()
            doc = server.fleet()
            names = [s["name"] for s in doc["fleet"]]
            assert "t" in names
        finally:
            v.stop()

    def test_fleet_flight_route_cursor(self, stubs, server):
        r1, _ = stubs
        t0 = time.time()
        r1.flight_events = [
            {"seq": 0, "time": t0, "kind": "k", "name": "a", "data": {},
             "pipeline": None}]
        v = _view({"r1": r1.endpoint})
        try:
            v.tick()
            doc = server.fleet_flight(name="t")
            assert [e["name"] for e in doc["events"]] == ["a"]
            cursor = doc["events"][-1]["fleet_seq"]
            assert server.fleet_flight(name="t",
                                       after=cursor)["events"] == []
        finally:
            v.stop()

    def test_fleet_flight_route_no_view_is_client_error(self, server):
        from nnstreamer_tpu_torch.service import ServiceError

        with pytest.raises(ServiceError):
            server.fleet_flight(name="nope")

    def test_spans_route_exports_wall_annotated(self, server):
        obs_ctx.enable_tracing()
        span = obs_ctx.start_span("t-span", kind="test")
        span.end()
        doc = server.spans(trace=span.trace_id)
        assert doc["pid"] > 0
        names = [s["name"] for s in doc["spans"]]
        assert names == ["t-span"]
        assert "start_wall_s" in doc["spans"][0]
        assert doc["spans"][0]["start_wall_s"] == pytest.approx(
            time.time(), abs=60.0)

    def test_profile_raw_and_quality_raw(self, server):
        obs_profile.enable_recording()
        obs_profile.default_profiler.record_request("serving:t", 0.01)
        doc = server.profile(raw=True)
        assert "serving:t" in doc["raw"]["requests"]
        assert "mono_to_wall" in doc["raw"]
        assert "raw" not in server.profile()
        qdoc = server.quality(raw=True)
        assert "cells" in qdoc
        assert "cells" not in server.quality()

    def test_flight_after_param(self, server):
        obs_flight.record("fleettest", "ev-a", {})
        evs = server.flight(category="fleettest")["events"]
        cursor = evs[-1]["seq"]
        obs_flight.record("fleettest", "ev-b", {})
        fresh = server.flight(category="fleettest", after=cursor)["events"]
        assert [e["name"] for e in fresh] == ["ev-b"]

    def test_obs_fleet_cli(self, stubs, capsys):
        from nnstreamer_tpu_torch.__main__ import main

        r1, _ = stubs
        v = _view({"r1": r1.endpoint})
        try:
            v.tick()
            assert main(["obs", "fleet"]) == 0
            out = json.loads(capsys.readouterr().out)
            assert out and out[0]["name"] == "t"
            assert out[0]["replicas"][0]["replica"] == "r1"
        finally:
            v.stop()


# ---------------------------------------------------------------------------
# the acceptance E2E: cross-process trace stitch + live-replica merge
# ---------------------------------------------------------------------------

@pytest.mark.thread_leak_ok
class TestCrossProcessE2E:
    def test_stitch_and_merge_across_subprocess_replicas(self):
        """ONE Perfetto document spans the process boundary: parent
        root/attempt spans and the subprocess replica's serving + fused
        spans under the SAME trace_id — and the fleet-merged request
        digest equals the manual merge of both replicas' raw exports.
        (thread_leak_ok: subprocess stdout readers drain on their own
        schedule, same stance as the procreplica E2E tests.)"""
        from nnstreamer_tpu_torch.service import ProcReplicaSet

        stage = ("tensor_filter framework=torch accelerator=cpu "
                 "model=builtin://scaler?factor=2 ! "
                 "tensor_filter framework=torch accelerator=cpu "
                 "model=builtin://scaler?factor=3")
        ps = ProcReplicaSet("fleete2e", stage, CAPS, replicas=2,
                            trace=True, quarantine_base_s=0.2,
                            health_poll_s=0.05)
        v = None
        try:
            ps.start()
            obs_ctx.enable_tracing()
            out = ps.request([np.ones(4, np.float32)], key="k",
                             timeout=30.0)
            assert np.allclose(np.asarray(out.tensors[0]), 6.0)
            for i in range(6):
                ps.request([np.ones(4, np.float32)], key=f"t{i}",
                           timeout=15.0)
            v = FleetView("fleete2e", source=ps, tick_s=0.5)
            assert set(v.tick().values()) == {"ok"}

            roots = [s for s in obs_ctx.finished_spans()
                     if s.kind == "fabric" and s.parent_id is None]
            tid = roots[-1].trace_id
            doc = v.stitch_trace(tid)
            spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            assert spans
            # single trace_id across every process lane
            assert {e["args"]["trace_id"] for e in spans} == {tid}
            lanes = {}
            for e in spans:
                lanes.setdefault(e["args"]["replica"], set()).add(e["cat"])
            assert "fabric" in lanes[PARENT_REPLICA]  # root + attempt
            child = [r for r in lanes if r != PARENT_REPLICA]
            assert len(child) == 1  # key-routed to one replica
            assert {"serving", "fused"} <= lanes[child[0]]
            # distinct process lanes + named metadata rows
            pids = {e["pid"] for e in spans}
            assert len(pids) == 2
            meta = [e for e in doc["traceEvents"]
                    if e.get("ph") == "M" and e["name"] == "process_name"]
            assert len(meta) == len(pids)

            # live two-replica merge: the fleet total equals the manual
            # bucket-wise merge of both children's raw exports
            per_replica = []
            for st in v._state_rows():
                req = st.profile_raw["requests"].get("serving:query")
                if req:
                    per_replica.append(QuantileDigest.from_dict(
                        req["total"]))
            assert len(per_replica) == 2  # both replicas served
            manual = per_replica[0]
            manual.merge(per_replica[1])
            merged = v.request_total("serving:query")
            assert merged.to_dict() == manual.to_dict()
            assert merged.count >= 7  # 7 requests (+ self-warmups)
        finally:
            if v is not None:
                v.stop()
            obs_ctx.disable_tracing()
            ps.stop()
