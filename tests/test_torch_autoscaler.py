"""The port's autoscaler and process replicas
(``nnstreamer_tpu_torch/service/{autoscaler,procreplica}.py``) against
nnstreamer_tpu's, on the CPU.

* the control loop: the port's and the reference's ``Autoscaler`` read the
  same synthetic load trace (each its own package's ``Profiler``, fed the
  same samples) and, tick by tick, take the same decisions: scale out on
  a hot short window, hold on few samples and in cooldowns, no flap on
  oscillating load, scale in only when every window is cool, scale-in
  and scale-out blocked by memory, the ceiling's overload guard, the
  respawn backoff and its circuit breaker;
* typed shedding: an armed pool and an armed serving queue refuse
  sheddable requests at once with ``OverloadShedError``;
* one ``ProcReplicaSet`` end to end: ``python -m nnstreamer_tpu_torch
  replica`` children with ``jax`` and ``nnstreamer_tpu`` unimportable
  serve, survive a SIGKILL (reap → evict → respawn → readmit) with zero
  client-visible errors."""
import os
import sys
import time

import numpy as np
import pytest

import nnstreamer_tpu.obs.profile as r_profile
import nnstreamer_tpu.service as R
from nnstreamer_tpu_torch.obs import profile as obs_profile
from nnstreamer_tpu_torch.service import (
    Autoscaler,
    AutoscalerConfig,
    ProcReplicaSet,
    ReplicaPool,
)
from nnstreamer_tpu_torch.serving.queue import RequestQueue
from nnstreamer_tpu_torch.serving.request import (
    AdmissionError,
    OverloadShedError,
    Request,
)

CAPS = "other/tensors,format=static,dimensions=4,types=float32"
T0 = 1000.0


class FakePool:
    name = "fakepool"

    def __init__(self):
        self.shed = None
        self.evicted = []

    def set_overload_shed(self, p):
        self.shed = p

    def clear_overload_shed(self):
        self.shed = None

    def evict(self, rid, reason):
        self.evicted.append((rid, reason))

    def remove(self, rid):
        pass


class FakeTarget:
    """A scaling target driven by ``tick(now=...)``; with ``proc=True`` it
    also has the subprocess verbs, with scripted deaths and respawns."""

    def __init__(self, n, proc=False):
        self.n = n
        self.pool = FakePool()
        self.events = []
        self.dead_queue, self.respawn_results = [], []
        self.respawn_calls, self.discarded = [], []
        if proc:
            self.reap_dead, self.respawn, self.discard = (
                self._reap_dead, self._respawn, self._discard)

    def replica_count(self):
        return self.n

    def scale_out(self):
        self.n += 1
        self.events.append(("out", self.n))
        return f"r{self.n}"

    def scale_in(self):
        self.n -= 1
        self.events.append(("in", self.n))
        return f"r{self.n + 1}"

    def _reap_dead(self):
        out, self.dead_queue = self.dead_queue, []
        return out

    def _respawn(self, rid):
        self.respawn_calls.append(rid)
        return self.respawn_results.pop(0) if self.respawn_results else True

    def _discard(self, rid):
        self.discarded.append(rid)
        self.n -= 1


CFG = dict(min_replicas=1, max_replicas=3, latency_slo_s=0.1, target=0.9,
           short_window_s=5.0, long_window_s=20.0, scale_out_burn=2.0,
           scale_in_burn=0.5, min_samples=5, scale_out_cooldown_s=3.0,
           scale_in_cooldown_s=6.0, respawn_backoff_base_s=0.5,
           respawn_backoff_factor=2.0, respawn_backoff_max_s=4.0,
           max_respawns=3, respawn_window_s=30.0)


class Lockstep:
    """The port's and the reference's autoscaler over twin fake targets
    and twin profilers; every feed goes to both, every tick compares."""

    def __init__(self, n, proc=False, mem=0.1, **cfg):
        kw = {**CFG, **cfg}
        self.targets = (FakeTarget(n, proc), FakeTarget(n, proc))
        self.profs = (obs_profile.Profiler(), r_profile.Profiler())
        self.scalers = tuple(
            mod(tgt, cfg_cls(**kw), name="t", series="fabric:fake",
                profiler=prof, memory_fraction_fn=lambda: mem)
            for mod, cfg_cls, tgt, prof in zip(
                (Autoscaler, R.Autoscaler),
                (AutoscalerConfig, R.AutoscalerConfig),
                self.targets, self.profs))
        self.decisions = []

    def feed(self, t, n=20, latency=0.5, span=1.0):
        for prof in self.profs:
            for i in range(n):
                prof.record_request("fabric:fake", latency, ok=True,
                                    now=t - span + span * i / n)

    def script(self, dead=(), results=()):
        for tgt in self.targets:
            tgt.dead_queue = list(dead)
            tgt.respawn_results = list(results)

    def tick(self, now):
        got, want = (dict(s.tick(now=now)) for s in self.scalers)
        for d in (got, want):
            d.pop("time")
        assert got == want
        snaps = [s.snapshot() for s in self.scalers]
        for snap in snaps:  # the decision's wall-clock stamp differs
            snap["last_decision"].pop("time", None)
        assert snaps[0] == snaps[1]
        tp, tr = self.targets
        assert (tp.n, tp.events, tp.pool.shed, tp.respawn_calls,
                tp.discarded) == (tr.n, tr.events, tr.pool.shed,
                                  tr.respawn_calls, tr.discarded)
        self.decisions.append(got["action"])
        return got


def _hot_short_window(ls):
    ls.feed(T0 - 6, n=100, latency=0.01, span=12.0)
    ls.feed(T0, n=20, latency=0.5, span=2.0)
    d = ls.tick(T0)
    assert d["burn_long"] < CFG["scale_out_burn"]


def _few_samples(ls):
    ls.feed(T0, n=3)
    ls.tick(T0)


def _cooldown(ls):
    for t in (T0, T0 + 1, T0 + 4):
        ls.feed(t)
        ls.tick(t)


def _hysteresis(ls):
    t = T0
    for step in range(30):
        bad = int(20 * (0.11 if step % 2 == 0 else 0.09))
        ls.feed(t, n=20 - bad, latency=0.01, span=0.9)
        ls.feed(t, n=bad, latency=0.5, span=0.9)
        ls.tick(t)
        t += 1.0


def _scale_in_all_cool(ls):
    ls.feed(T0 - 8, n=40, latency=0.5, span=4.0)
    ls.feed(T0, n=40, latency=0.01, span=4.0)
    ls.tick(T0)
    ls.tick(T0 + 25.0)


def _memory_blocks(ls):
    ls.tick(T0 + 100)
    ls.feed(T0 + 101)
    ls.tick(T0 + 101)


def _ceiling(ls):
    ls.feed(T0)
    ls.tick(T0)
    ls.tick(T0 + 60.0)


def _respawn_backoff(ls):
    ls.script(dead=["r-a"], results=[False, False, True])
    for t in (T0, T0 + 0.2, T0 + 0.6, T0 + 1.0, T0 + 1.7, T0 + 10.0):
        ls.tick(t)


def _respawn_breaker(ls):
    t = T0
    for _ in range(4):
        ls.script(dead=["r-b"])
        ls.tick(t)
        t += 1.0
    ls.tick(t + 5.0)


SCENARIOS = {
    "hot_short_window": (dict(n=1), _hot_short_window, ["scale_out"]),
    "few_samples": (dict(n=1), _few_samples, ["hold"]),
    "cooldown": (dict(n=1), _cooldown, ["scale_out", "hold", "scale_out"]),
    "hysteresis": (dict(n=2), _hysteresis, ["hold"] * 30),
    "scale_in_all_cool": (dict(n=2), _scale_in_all_cool,
                          ["hold", "scale_in"]),
    "memory_blocks": (dict(n=2, mem=0.6), _memory_blocks,
                      ["blocked:memory", "scale_out"]),
    "scale_out_memory": (dict(n=1, mem=0.9), _ceiling,
                         ["blocked:memory", "hold"]),
    "ceiling_shed": (dict(n=3), _ceiling, ["blocked:ceiling", "scale_in"]),
    "respawn_backoff": (dict(n=2, proc=True, min_replicas=2),
                        _respawn_backoff,
                        ["hold"] * 6),
    "respawn_breaker": (dict(n=2, proc=True, min_replicas=2, max_respawns=3,
                             respawn_window_s=100.0,
                             respawn_backoff_base_s=0.1,
                             respawn_backoff_max_s=0.2),
                        _respawn_breaker,
                        ["hold", "hold", "hold", "hold", "hold"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_trace_same_decisions_as_the_reference(name):
    kw, run, actions = SCENARIOS[name]
    ls = Lockstep(**kw)
    run(ls)
    assert ls.decisions == actions


def test_respawn_schedule_and_breaker_counts():
    ls = Lockstep(**SCENARIOS["respawn_backoff"][0])
    _respawn_backoff(ls)
    tgt = ls.targets[0]
    assert len(tgt.respawn_calls) == 3
    snap = ls.scalers[0].snapshot()
    assert (snap["respawns"], snap["respawn_failures"]) == (1, 2)
    ls = Lockstep(**SCENARIOS["respawn_breaker"][0])
    _respawn_breaker(ls)
    assert ls.targets[0].discarded == ["r-b"]
    assert ls.scalers[0].snapshot()["respawn_gave_up"] == 1


def test_config_validation_matches_the_reference():
    bad = [dict(min_replicas=3, max_replicas=2),
           dict(scale_in_burn=2.0, scale_out_burn=2.0), dict(target=1.5),
           dict(memory_max_fraction=0.0),
           dict(short_window_s=10.0, long_window_s=5.0)]
    for kw in bad:
        with pytest.raises(ValueError):
            AutoscalerConfig(**kw)
        with pytest.raises(ValueError):
            R.AutoscalerConfig(**kw)


class TestTypedShedding:
    def test_pool_shed_is_typed_and_fail_fast(self):
        pool = ReplicaPool("shedpool", CAPS)
        try:
            pool.set_overload_shed(1)
            t0 = time.monotonic()
            with pytest.raises(OverloadShedError) as ei:
                pool.request([np.ones(4, np.float32)], key="k",
                             timeout=5.0, priority=1)
            assert time.monotonic() - t0 < 0.5
            assert isinstance(ei.value, AdmissionError)
            assert pool.snapshot()["shed_overload"] == 1
            # priority 0 passes the guard (and fails on routing instead)
            with pytest.raises(Exception) as ei:
                pool.request([np.ones(4, np.float32)], key="k",
                             timeout=0.3, priority=0)
            assert not isinstance(ei.value, OverloadShedError)
            pool.clear_overload_shed()
            assert pool.overload_shed() is None
        finally:
            pool.close()

    def test_serving_queue_sheds_and_the_autoscaler_arms_it(self):
        q = RequestQueue(max_depth=8)
        q.set_overload(2)
        req = Request([np.ones((1, 4), np.float32)], priority=2)
        with pytest.raises(OverloadShedError):
            q.put(req)
        assert req.done() and isinstance(req.error, OverloadShedError)
        q.put(Request([np.ones((1, 4), np.float32)], priority=0))
        assert q.depth() == 1
        q.clear_overload()
        ls = Lockstep(n=3)
        ls.scalers[0].add_shed_queue(q)
        ls.feed(T0)
        ls.tick(T0)
        assert q.overload_min_priority() == CFG.get("shed_priority", 1)
        ls.tick(T0 + 60.0)
        assert q.overload_min_priority() is None


# the child interpreter: jax and nnstreamer_tpu unimportable, then the
# package's entry point as ``python -m`` runs it
_BLOCKED = """import runpy, sys
for name in ("jax", "jaxlib", "nnstreamer_tpu"):
    sys.modules[name] = None
sys.argv = [sys.argv[0]] + sys.argv[3:]
runpy.run_module("nnstreamer_tpu_torch", run_name="__main__", alter_sys=True)
"""


@pytest.fixture()
def blocked_python(tmp_path):
    """An executable that takes ``-m nnstreamer_tpu_torch ...`` like
    python, with jax and nnstreamer_tpu blocked in the child."""
    script = tmp_path / "blocked.py"
    script.write_text(_BLOCKED)
    exe = tmp_path / "python-blocked"
    exe.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    exe.chmod(0o755)
    return str(exe)


@pytest.mark.thread_leak_ok
@pytest.mark.timeout_s(60)
def test_proc_replicas_spawn_kill_respawn_readmit_zero_errors(
        blocked_python):
    """Two ``replica`` children serve the scaler; one is SIGKILLed while
    requests flow; the set reaps, evicts, respawns and readmits it with
    zero client-visible errors, answers equal to the scaler's."""
    ps = ProcReplicaSet(
        "t-e2e", "tensor_filter framework=torch accelerator=cpu "
        "model=registry://m", CAPS, replicas=2,
        models={"m": {"versions": {"1": "builtin://scaler?factor=2"},
                      "active": "1"}},
        python=blocked_python, quarantine_base_s=0.2, health_poll_s=0.05,
        spawn_timeout_s=45.0)
    try:
        ps.start()
        with ps._lock:
            infos = [ps._slots[r].proc.info for r in ps._order]
        assert [i["devices"] for i in infos] == [["cpu"], ["cpu"]]
        for k in range(4):
            out = ps.request([np.full(4, float(k), np.float32)],
                             key=f"a{k}", timeout=20.0)
            np.testing.assert_array_equal(np.asarray(out.tensors[0]),
                                          np.full(4, 2.0 * k, np.float32))
        killed = ps.kill_replica(0)
        deadline = time.monotonic() + 20
        dead = []
        while not dead and time.monotonic() < deadline:
            dead = ps.reap_dead()
            time.sleep(0.01)
        assert dead == [killed]
        for k in range(6):  # the survivor answers every key meanwhile
            out = ps.request([np.ones(4, np.float32)], key=f"b{k}",
                             timeout=20.0)
            assert np.asarray(out.tensors[0]).tolist() == [2.0] * 4
        assert ps.respawn(killed)
        while (ps.pool.snapshot()["readmissions"] < 1
               and time.monotonic() < deadline + 20):
            time.sleep(0.02)
        snap = ps.pool.snapshot()
        assert snap["evictions"] >= 1 and snap["readmissions"] >= 1
        assert snap["request_errors"] == 0
        assert killed in ps.pool.replicas()
        assert sum(p["alive"] for p in ps.snapshot()["processes"]) == 2
        assert os.path.basename(blocked_python) == "python-blocked"
    finally:
        ps.stop()
