"""The port's sanitizer and observability plane against nnstreamer_tpu's,
call for call: the same calls go to both packages and the reports must
agree — the lock-order graph and its violations, the leak ledger, the
Prometheus text of a registry, the serving collector's counters, the span
tree of a trace and the flight recorder's dump. Call sites, thread
names, ids and clock readings are where the two runs differ by nature,
and are left out of the comparison."""
import re

import numpy as np
import pytest

from nnstreamer_tpu.analysis import sanitizer as jsan
from nnstreamer_tpu.obs import context as jctx
from nnstreamer_tpu.obs import flight as jflight
from nnstreamer_tpu.obs import metrics as jmetrics
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.obs import context as tctx
from nnstreamer_tpu_torch.obs import flight as tflight
from nnstreamer_tpu_torch.obs import metrics as tmetrics

SANS = {"ref": jsan, "port": tsan}


@pytest.fixture
def tsan_on():
    """Both lock-order sanitizers on for the test, restored after (a
    session that runs with NNS_TSAN=1 keeps them on)."""
    was = {k: s.is_enabled() for k, s in SANS.items()}
    for s in SANS.values():
        s.enable(hold_warn_s=60.0)
    yield SANS
    for k, s in SANS.items():
        if was[k]:
            s.enable(hold_warn_s=60.0)
        else:
            s.disable()
            s.reset()


@pytest.fixture
def leak_on():
    was = {k: s.leakcheck_enabled() for k, s in SANS.items()}
    for s in SANS.values():
        s.enable_leakcheck()
    yield SANS
    for k, s in SANS.items():
        if was[k]:
            s.enable_leakcheck()
        else:
            s.disable_leakcheck()
            s.reset_leakcheck()


def _lock_order_run(san):
    a = san.named_lock("obs-test.A")
    b = san.named_lock("obs-test.B")
    c = san.named_condition("obs-test.C", lock=san.named_lock("obs-test.L"))
    r = san.named_rlock("obs-test.R")
    with a:
        with b:
            pass
    with r:
        with r:            # re-entry: no new node
            with a:
                pass
    with c:
        c.wait(0.001)      # the wait releases and re-takes the lock
        with b:
            pass
    with b:
        with a:            # opposite order: a cycle
            pass
    rep = san.report()
    edges = [(e["from"], e["to"], e["count"]) for e in rep["edges"]
             if e["from"].startswith("obs-test")]
    viol = [(v["type"], v["edge"], v["cycle"]) for v in san.violations()]
    locks = {k: v for k, v in rep["locks"].items()
             if k.startswith("obs-test")}
    return edges, viol, locks


def test_lock_order_report_matches(tsan_on):
    want = _lock_order_run(jsan)
    got = _lock_order_run(tsan)
    assert got == want
    edges, viol, _ = got
    assert ("obs-test.A", "obs-test.B", 1) in edges
    assert viol == [("lock-order", ["obs-test.B", "obs-test.A"],
                     ["obs-test.B", "obs-test.A", "obs-test.B"])]


def test_disabled_factories_return_raw_primitives():
    import threading

    for san in SANS.values():
        if san.is_enabled():
            pytest.skip("a session-wide NNS_TSAN run keeps them on")
        assert type(san.named_lock("x")) is type(threading.Lock())
        assert type(san.named_rlock("x")) is type(threading.RLock())
        assert isinstance(san.named_condition("x"), threading.Condition)


def _leak_run(san):
    san.reset_leakcheck()
    san.note_acquire("kv_page", "pool:p1", detail="one")
    san.note_acquire("kv_page", "pool:p2")
    san.note_acquire("kv_page", "pool:p2")
    san.note_acquire("metrics_registration", "m", idempotent=True)
    san.note_acquire("metrics_registration", "m", idempotent=True)
    san.note_release("kv_page", "pool:p1")
    san.note_release("kv_page", "pool:p2")
    san.note_release("kv_page", "never-acquired")
    rows = sorted((r["kind"], r["key"], r["count"], r["detail"])
                  for r in san.outstanding())
    rep = san.leak_report()
    return (rows, rep["enabled"], rep["acquired_total"],
            rep["outstanding_units"], san.outstanding("kv_page") != [])


def test_leak_ledger_matches(leak_on):
    got, want = _leak_run(tsan), _leak_run(jsan)
    assert got == want
    assert got[0] == [("kv_page", "pool:p2", 1, ""),
                      ("metrics_registration", "m", 1, "")]


def test_transfer_ledger_sizes_torch_tensors():
    import torch

    assert tsan.nbytes_of([torch.zeros(3, 4), np.zeros(5, np.uint8),
                           b"abc"]) == 48 + 5 + 3
    assert tsan.nbytes_of([np.zeros(5, np.uint8), b"abc"]) == \
        jsan.nbytes_of([np.zeros(5, np.uint8), b"abc"])


def _render_run(metrics):
    reg = metrics.Registry()
    c = reg.counter("nns_test_requests_total", "requests", ("pool",))
    c.inc(pool="a")
    c.inc(2.5, pool='b"q\\uote\n')
    c.set_total(7, pool="c")
    g = reg.gauge("nns_test_depth", "queue depth")
    g.set(3)
    g.inc(-1)
    h = reg.histogram("nns_test_latency_seconds", "latency", ("stage",),
                      buckets=metrics.Histogram.LATENCY_BUCKETS_STAGE)
    for v in (0.0002, 0.003, 0.003, 0.7, 2.0):
        h.observe(v, stage="s0")
    reg.register_collector("mirror", lambda r: r.gauge(
        "nns_test_mirror", "from a collector").set(42))
    with pytest.raises(metrics.MetricError):
        reg.gauge("nns_test_requests_total")
    with pytest.raises(metrics.MetricError):
        c.inc(other="x")
    return reg.render()


def test_registry_render_text_matches():
    got, want = _render_run(tmetrics), _render_run(jmetrics)
    assert got == want
    assert 'nns_test_requests_total{pool="b\\"q\\\\uote\\n"} 2.5' in got
    assert 'nns_test_latency_seconds_bucket{stage="s0",le="+Inf"} 5' in got


def _serving_lines(render: str, name: str):
    keep = ("submitted", "completed", "failed", "shed", "batches_total",
            "queue_depth")
    return sorted(ln for ln in render.splitlines()
                  if f'scheduler="{name}"' in ln
                  and any(k in ln for k in keep))


def test_serving_collector_counters_match():
    from nnstreamer_tpu.serving import Scheduler as JScheduler
    from nnstreamer_tpu_torch.serving import Scheduler as TScheduler

    lines = {}
    for key, cls, render in (("ref", JScheduler, jmetrics.render),
                             ("port", TScheduler, tmetrics.render)):
        sched = cls(lambda x: (x + 1,), bucket_sizes=(4,),
                    max_wait_s=0.001, name="obs-collector-test")
        try:
            for r in [sched.submit((np.ones((1, 3), np.float32),))
                      for _ in range(3)]:
                r.result(60)
            lines[key] = _serving_lines(render(), sched.name)
        finally:
            sched.close()
    assert lines["port"] == lines["ref"]
    assert any("nns_serving_completed_total" in ln and ln.endswith(" 3")
               for ln in lines["port"])


def _span_run(ctx):
    ctx.reset()
    ctx.enable_tracing()
    try:
        root = ctx.start_span("request", kind="client",
                              attrs={"request_id": 1})
        child = ctx.start_span("attempt", kind="fabric", parent=root)
        child.end("error:ConnectionError")
        retry = ctx.start_span("attempt", kind="fabric",
                               parent=root.context().to_meta())
        retry.end()
        ctx.record_span("batch:s", kind="serving",
                        links=[retry.context(), None], dur_s=0.5,
                        attrs={"rows": 2})
        root.end()
        root.end("late")      # idempotent
        bad = ctx.TraceContext.from_meta({"trace_id": 5})
    finally:
        ctx.disable_tracing()
    doc = ctx.export_chrome_trace()
    names = {}
    for ev in doc["traceEvents"]:
        names[ev["args"]["span_id"]] = ev["name"]
    out = []
    for ev in doc["traceEvents"]:
        a = ev["args"]
        out.append((ev["name"], ev["cat"], ev["ph"], a["status"],
                    names.get(a["parent_span_id"]),
                    [names[ln["span_id"]] for ln in a["links"]],
                    {k: v for k, v in a.items() if k in ("rows",
                                                         "request_id")},
                    round(ev["dur"] / 1e6, 3) if ev["name"] == "batch:s"
                    else None))
    one_trace = len({ev["args"]["trace_id"] for ev in doc["traceEvents"]
                     if ev["name"] != "batch:s"}) == 1
    return out, one_trace, bad


def test_span_tree_and_export_match():
    got, want = _span_run(tctx), _span_run(jctx)
    assert got == want
    spans, one_trace, bad = got
    assert one_trace and bad is None
    assert spans[0][:5] == ("attempt", "fabric", "X",
                            "error:ConnectionError", "request")
    assert spans[2][5] == ["attempt"]   # the batch links the retry


def _flight_run(flight):
    rec = flight.FlightRecorder(capacity=4)
    for i in range(6):
        rec.record("serving" if i % 2 else "memory", f"ev{i}", {"i": i},
                   pipeline="p" if i > 3 else None)
    strip = (lambda rows: [(r["seq"], r["kind"], r["name"], r["data"],
                            r["pipeline"]) for r in rows])
    return (rec.count(), strip(rec.dump()), strip(rec.dump(last=2)),
            strip(rec.dump(category="memory")),
            strip(rec.dump(pipeline="p")), strip(rec.dump(after=3)))


def test_flight_recorder_dump_matches():
    got, want = _flight_run(tflight), _flight_run(jflight)
    assert got == want
    assert got[0] == 6 and [r[0] for r in got[1]] == [2, 3, 4, 5]
    with pytest.raises(ValueError):
        tflight.FlightRecorder(capacity=0)


def test_flight_recorder_keeps_finished_spans():
    before = tflight.count()
    tctx.record_span("probe", kind="test")
    tail = tflight.dump(last=1)
    assert tflight.count() == before + 1
    assert tail[0]["kind"] == "span" and tail[0]["name"] == "test:probe"
    assert re.fullmatch(r"s[0-9a-f]+", tail[0]["data"]["span"])
