"""Declarative SLOs (obs/slo.py): the port against nnstreamer_tpu.

Both engines evaluate the same sample sequence (injected clock) and
must agree exactly: burn rates, bad fractions, sample counts, alert
states, the flight events of breaches and recoveries, and the service
flips they drive. The service side is a stand-in with the reference
``Service``'s health surface (``readiness``, ``mark_degraded_external``,
``mark_recovered``); the port has no service manager yet."""
import pytest

from nnstreamer_tpu.obs import flight as jflight
from nnstreamer_tpu.obs import memory as jmemory
from nnstreamer_tpu.obs import profile as jprofile
from nnstreamer_tpu.obs import quality as jquality
from nnstreamer_tpu.obs import slo as jslo
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.obs import flight as tflight
from nnstreamer_tpu_torch.obs import memory as tmemory
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import profile as tprofile
from nnstreamer_tpu_torch.obs import quality as tquality
from nnstreamer_tpu_torch.obs import slo as tslo

PORT = (tprofile, tslo, tflight, tquality, tmemory)
REF = (jprofile, jslo, jflight, jquality, jmemory)


@pytest.fixture(autouse=True)
def _clean():
    before = len(tsan.violations())
    for prof, *_ in (PORT, REF):
        prof.stop()
        prof.disable_recording()
        prof.reset()
    yield
    for prof, _, _, quality, _ in (PORT, REF):
        prof.stop()
        prof.disable_recording()
        prof.reset()
        quality.stop()
        quality.reset()
    assert tsan.violations()[before:] == []


class _Service:
    def __init__(self, ready=True):
        self.ready = ready
        self.log = []

    def readiness(self):
        return self.ready

    def mark_degraded_external(self, reason):
        if not self.ready:
            return False
        self.ready = False
        self.log.append(("degraded", reason))
        return True

    def mark_recovered(self, reason):
        self.ready = True
        self.log.append(("ready", reason))


class _Manager:
    def __init__(self, **services):
        self.services = services

    def get(self, name):
        return self.services[name]


def _strip(statuses):
    return [{k: v for k, v in st.items() if k != "since"}
            for st in statuses]


def _slo_events(flight, seq0):
    return [(e["name"], e["data"]) for e in flight.dump()
            if e["kind"] == "slo" and e["seq"] > seq0]


def _drive(mods, script):
    """Run ``script(engine, profiler, obs)`` against one package and
    return everything observable: statuses after each step, the slo
    flight events and the stand-in services' logs."""
    prof, slo, flight, quality, memory = mods
    seq0 = max((e["seq"] for e in flight.dump()), default=-1)
    mgr = _Manager(svc=_Service(), down=_Service(ready=False))
    prof.enable_recording()
    eng = slo.SloEngine(manager=mgr, name="unit")
    out = script(eng, prof.default_profiler, slo, quality)
    return ([_strip(s) for s in out], _slo_events(flight, seq0),
            {n: s.log for n, s in mgr.services.items()},
            [_strip(slo.status_all())])


def _same(script):
    got, want = _drive(PORT, script), _drive(REF, script)
    assert got == want
    return got


def test_latency_burn_breach_and_recovery():
    def script(eng, p, slo, _q):
        eng.add(slo.SLObjective("u-p99", kind="latency", series="unit:lat",
                                target=0.99, threshold_s=0.1,
                                service="svc",
                                windows=((2.0, 4.0, 2.0), (4.0, 8.0, 1.0))))
        out, now = [], 1000.0
        for _ in range(100):
            p.record_request("unit:lat", 0.01, now=now)
        out.append(eng.evaluate(now=now))
        for _ in range(43):
            p.record_request("unit:lat", 0.5, now=now + 0.5)
        out.append(eng.evaluate(now=now + 0.5))
        out.append(eng.evaluate(now=now + 1.0))   # still alerting
        for _ in range(50):
            p.record_request("unit:lat", 0.01, now=now + 10.0)
        out.append(eng.evaluate(now=now + 10.0))
        return out

    (states, events, logs, _) = _same(script)
    alerting = [s[0]["alerting"] for s in states]
    assert alerting == [False, True, True, False]
    assert states[1][0]["windows"][0]["burn_short"] == pytest.approx(
        30.07, rel=0.01)
    assert [name for name, _ in events] == ["breach", "recover"]
    assert [k for k, _ in logs["svc"]] == ["degraded", "ready"]


def test_error_rate_and_two_objectives_hold_the_service():
    def script(eng, p, slo, _q):
        eng.add(slo.SLObjective("hold-lat", kind="latency",
                                series="unit:a", target=0.99,
                                threshold_s=0.05, service="svc",
                                windows=((2.0, 4.0, 2.0),)))
        eng.add(slo.SLObjective("hold-err", kind="error_rate",
                                series="unit:b", target=0.99, service="svc",
                                windows=((2.0, 4.0, 2.0),)))
        out, now = [], 5000.0
        for i in range(50):
            p.record_request("unit:a", 0.5, now=now)
            p.record_request("unit:b", 0.01, ok=(i % 10 != 0), now=now)
        out.append(eng.evaluate(now=now))
        for i in range(50):
            p.record_request("unit:a", 0.001, now=now + 10.0)
            p.record_request("unit:b", 0.01, ok=False, now=now + 10.0)
        out.append(eng.evaluate(now=now + 10.0))
        for _ in range(50):
            p.record_request("unit:b", 0.01, now=now + 20.0)
        out.append(eng.evaluate(now=now + 20.0))
        return out

    states, _, logs, _ = _same(script)
    assert [[s["alerting"] for s in st] for st in states] == \
        [[True, True], [False, True], [False, False]]
    assert [k for k, _ in logs["svc"]] == ["degraded", "ready"]


def test_availability_alerts_without_degrading():
    def script(eng, p, slo, _q):
        eng.add(slo.SLObjective("u-avail", kind="availability",
                                service="down", target=0.99,
                                windows=((2.0, 4.0, 1.0),)))
        return [eng.evaluate(now=3000.0 + i * 0.2) for i in range(5)]

    states, events, logs, _ = _same(script)
    assert states[-1][0]["series"] == "availability:down"
    assert states[-1][0]["alerting"] and logs["down"] == []


def test_memory_and_quality_objectives_sample_themselves():
    def script(eng, p, slo, quality):
        eng.add(slo.SLObjective("mem", kind="memory", threshold_s=0.9,
                                target=0.9, windows=((2.0, 4.0, 1.0),)))
        eng.add(slo.SLObjective("qual", kind="quality", threshold_s=0.25,
                                target=0.9, service="svc",
                                windows=((2.0, 4.0, 1.0),)))
        import numpy as np

        quality.start(sample_every=1)
        acc = quality.accountant()
        out = [eng.evaluate(now=100.0)]
        acc.observe("p:edge", [np.full(8, np.nan, np.float32)])
        out.append(eng.evaluate(now=100.5))
        out.append(eng.evaluate(now=110.0))
        quality.stop()
        return out

    # the reference samples jax's CPU devices (used fraction 0.0 with no
    # budget), the port cuda devices (none here): both sample 0.0
    states, events, logs, _ = _same(script)
    assert [s[1]["alerting"] for s in states] == [False, True, False]
    assert [s[0]["alerting"] for s in states] == [False, False, False]
    assert states[0][0]["series"] == "memory:devices"
    assert states[0][1]["series"] == "quality:stages"
    assert [k for k, _ in logs["svc"]] == ["degraded", "ready"]


@pytest.mark.parametrize("kw", [
    {"kind": "nope", "series": "s"}, {"kind": "latency", "series": ""},
    {"kind": "availability"}, {"series": "s", "target": 1.5},
    {"series": "s", "windows": ((5.0, 1.0, 1.0),)},
    {"series": "s", "windows": ()},
    {"kind": "memory", "threshold_s": 1.5},
    {"kind": "quality", "threshold_s": 0.0}])
def test_objective_validation_matches(kw):
    msgs = []
    for slo in (tslo, jslo):
        with pytest.raises(ValueError) as ei:
            slo.SLObjective("x", **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_spec_and_remove_match():
    for slo in (tslo, jslo):
        eng = slo.SloEngine(name="spec")
        eng.add(slo.SLObjective("a", series="s"))
        eng.add(slo.SLObjective("b", kind="quality"))
        eng.remove("a")
        assert [o.name for o in eng.objectives()] == ["b"]
    assert tslo.SLObjective("a", series="s").spec() == \
        jslo.SLObjective("a", series="s").spec()
    assert tslo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS


def test_engine_thread_and_recording_halves():
    eng = tslo.SloEngine(name="unit-halves", tick_s=0.01)
    eng.add(tslo.SLObjective("t", series="unit:t", windows=((1, 2, 1),)))
    eng.start()
    try:
        assert tprofile.ACTIVE
        tprofile.start()
        tprofile.stop()
        assert tprofile.ACTIVE
    finally:
        eng.stop()
    assert not tprofile.ACTIVE
    assert eng not in list(tslo._engines)


def test_gauges_render():
    tprofile.enable_recording()
    eng = tslo.SloEngine(name="unit-g")
    eng.add(tslo.SLObjective("g", series="unit:g", target=0.99,
                             threshold_s=0.1, windows=((2.0, 4.0, 2.0),)))
    for _ in range(10):
        tprofile.default_profiler.record_request("unit:g", 0.5, now=50.0)
    eng.evaluate(now=50.0)
    text = tmetrics.render()
    # burn = 1.0 / (1 - 0.99), in float arithmetic
    assert f'nns_slo_burn_rate{{slo="g",window="2s"}} {1.0 / (1 - 0.99)!r}' \
        in text
    assert 'nns_slo_alerting{slo="g"} 1' in text
