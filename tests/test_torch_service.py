"""The port's service control plane (``nnstreamer_tpu_torch/service/``)
against nnstreamer_tpu's, on the CPU.

The cases of the reference's ``tests/test_service.py`` (lifecycle,
admission, supervision, swap, canary, health, query attach, the HTTP
control surface), each on the port with ``accelerator=cpu``. Where a case
has an output, it is held against the reference's: the admission
diagnostics against the reference's lint on the same line, the restart
schedule against the reference's policy under the same seed, the canary
split against the reference's router, and a MobileNet-v2 slot swapped
mid-stream against the reference's forward on the same weights and frames
(carried by ``models/convert.py``; float32 both sides, 1e-5 on the
logits). Timings are never compared. Plus the two fusion cases of the
reference's ``tests/test_fusion.py`` that wait for the service plane."""
import dataclasses
import random
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nnstreamer_tpu.analysis as R_analysis
import nnstreamer_tpu.service as R
from nnstreamer_tpu.models.mobilenet_v2 import build_mobilenet_v2 as jbuild
from nnstreamer_tpu_torch.models import mobilenet_v2 as tmb
from nnstreamer_tpu_torch.models._blocks import make_u8_entry
from nnstreamer_tpu_torch.service import (
    AdmissionRejected,
    ControlClient,
    ControlServer,
    RestartPolicy,
    ServiceError,
    ServiceManager,
    ServiceState,
    SwapError,
)

SRC = ("tensor_src num-buffers=-1 framerate=500 dimensions=4 "
       "types=float32 pattern=counter ")
FILTER_LINE = (SRC + "! tensor_filter framework=torch accelerator=cpu "
               "model=registry://{slot} name=f ! tensor_sink name=out "
               "max-stored=256")
FINITE = ("tensor_src num-buffers={n} framerate=500 dimensions=4 "
          "types=float32 pattern=counter ! queue "
          "! tensor_sink name=out max-stored=512")
CRASHY = ("tensor_src num-buffers=40 framerate=500 dimensions=2 "
          "types=float32 ! tensor_fault crash-at-buffer={at} {extra} "
          "! tensor_sink name=out")
MODULE = __name__
LOGIT_ATOL = 1e-5


@pytest.fixture
def mgr():
    m = ServiceManager(jitter_seed=7)
    yield m
    m.shutdown()


def wait_state(svc, state, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if svc.state is state:
            return True
        time.sleep(0.02)
    return svc.state is state


def wait_for(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def fast_policy(**kw):
    kw.setdefault("mode", "on-failure")
    kw.setdefault("backoff_base_s", 0.02)
    kw.setdefault("jitter", 0.0)
    return RestartPolicy(**kw)


# -- lifecycle ---------------------------------------------------------------

class TestLifecycle:
    def test_register_is_inert(self, mgr):
        svc = mgr.register("s", FINITE.format(n=5))
        assert svc.state is ServiceState.REGISTERED
        assert svc.pipeline is None
        assert mgr.list()[0]["name"] == "s"

    def test_start_reaches_ready_after_a_buffer_and_negotiated_caps(self, mgr):
        svc = mgr.register("s", FINITE.format(n=-1))
        assert not svc.readiness()
        svc.start()
        assert svc.state is ServiceState.READY
        assert [s for _, s, _ in svc.history()][:3] == [
            "registered", "starting", "ready"]
        assert svc.readiness() and svc.liveness()
        assert svc.pipeline.sink_buffer_count >= 1
        caps = [p.caps for el in svc.pipeline.elements.values()
                for p in el.sink_pads if p.is_linked]
        assert caps and all(c is not None for c in caps)

    def test_stop_drain_restart(self, mgr):
        svc = mgr.register("s", FINITE.format(n=-1)).start()
        assert svc.uptime_s() > 0
        svc.stop()
        assert svc.state is ServiceState.STOPPED
        assert not svc.pipeline.playing and svc.uptime_s() == 0.0
        assert not svc.readiness() and svc.liveness()
        svc.start()
        assert svc.state is ServiceState.READY and svc.generation == 2
        svc.drain(timeout_s=10)
        assert svc.state is ServiceState.STOPPED
        assert svc.state_reason == "drained"
        assert svc.pipeline.get("out").buffer_count >= 1

    def test_finite_stream_completes_as_stopped(self, mgr):
        svc = mgr.register("s", FINITE.format(n=8), restart=fast_policy())
        svc.start(wait=False)
        assert wait_state(svc, ServiceState.STOPPED)
        assert "eos" in svc.state_reason

    def test_duplicate_name_and_unregister(self, mgr):
        svc = mgr.register("s", FINITE.format(n=-1)).start()
        with pytest.raises(ServiceError, match="already registered"):
            mgr.register("s", FINITE.format(n=5))
        mgr.unregister("s")
        assert not svc.pipeline.playing
        assert mgr.list() == []


# -- admission lint ----------------------------------------------------------

class TestAdmission:
    @pytest.mark.parametrize("line", [
        "tensor_src ! tensor_flter ! tensor_sink",
        "videotestsrc ! tensor_filter framework=torch "
        "model=builtin://passthrough ! tensor_sink",
        "tensor_src dimensions=3:8:8:2 types=uint8 num-buffers=1 "
        "! other/tensors,types=float32 ! tensor_sink",
    ], ids=["unknown-element", "unbuildable", "caps-mismatch"])
    def test_rejected_with_the_reference_diagnostics(self, mgr, line):
        with pytest.raises(AdmissionRejected) as ei:
            mgr.register("bad", line)
        want = [d for d in R_analysis.lint_launch(line) if d.is_error]
        assert [(d.rule, str(d.severity)) for d in ei.value.diagnostics] \
            == [(d.rule, str(d.severity)) for d in want]
        assert mgr.list() == []  # nothing half-registered

    def test_warn_mode_admits_anyway(self, mgr):
        svc = mgr.register("tolerated", "tensor_src num-buffers=1",
                           lint="warn")
        assert svc.state is ServiceState.REGISTERED

    def test_pbtxt_registration(self, mgr):
        from nnstreamer_tpu_torch.runtime.parse import parse_launch
        from nnstreamer_tpu_torch.runtime.pbtxt import to_pbtxt

        pbtxt = to_pbtxt(parse_launch(FINITE.format(n=3)))
        svc = mgr.register("from-pbtxt", pbtxt=pbtxt)
        assert svc.state is ServiceState.REGISTERED


# -- supervision -------------------------------------------------------------

class TestSupervision:
    def test_backoff_schedule_equals_the_reference(self):
        kw = dict(backoff_base_s=0.1, backoff_factor=2.0, backoff_max_s=0.5,
                  jitter=0.0)
        got = [RestartPolicy(**kw).delay_s(i) for i in range(6)]
        assert got == [R.RestartPolicy(**kw).delay_s(i) for i in range(6)]
        assert got[:4] == [0.1, 0.2, 0.4, 0.5]

    def test_seeded_jitter_equals_the_reference(self):
        p, q = (RestartPolicy(backoff_base_s=1.0, jitter=0.2),
                R.RestartPolicy(backoff_base_s=1.0, jitter=0.2))
        rp, rq = random.Random(3), random.Random(3)
        got = [p.delay_s(i % 3, rp) for i in range(50)]
        assert got == [q.delay_s(i % 3, rq) for i in range(50)]
        assert len(set(got)) > 3

    def test_crash_restarts_on_failure(self, mgr):
        svc = mgr.register(
            "crashy",
            "tensor_src num-buffers=40 framerate=500 dimensions=2 "
            "types=float32 pattern=counter ! tensor_fault "
            "crash-at-buffer=10 ! queue ! tensor_sink name=out "
            "max-stored=128", restart=fast_policy())
        svc.start()
        assert wait_state(svc, ServiceState.STOPPED)
        assert svc.supervisor.restarts == 1
        assert svc.pipeline.get("out").buffer_count > 0

    def test_policy_never_fails_fast_with_a_postmortem(self, mgr):
        svc = mgr.register("crashy", CRASHY.format(at=4, extra="name=f"),
                           restart=RestartPolicy(mode="never"))
        svc.start(wait=False)
        assert wait_state(svc, ServiceState.FAILED)
        assert svc.supervisor.restarts == 0 and not svc.liveness()
        (report,) = svc.supervisor.crash_reports
        assert "injected crash" in report.error
        assert report.reason == "error" and report.source == "f"
        assert any("other/tensors" in c for c in report.buffer_specs.values())
        assert report.element_stats["f"]["crashed"] == 1

    def test_circuit_breaker_opens_and_start_resets_it(self, mgr):
        svc = mgr.register(
            "looper", CRASHY.format(at=5, extra="crash-repeat=true"),
            restart=fast_policy(max_restarts=1, window_s=60.0))
        svc.start(wait=False)
        assert wait_state(svc, ServiceState.FAILED)
        assert svc.supervisor.breaker_open
        assert svc.supervisor.restarts == 1
        svc.start(wait=False)  # breaker + crash window cleared
        assert svc.supervisor.snapshot()["crashes_in_window"] == 0
        assert wait_state(svc, ServiceState.FAILED)
        assert svc.supervisor.restarts == 2

    def test_error_burst_counts_as_one_crash(self, mgr):
        svc = mgr.register("bursty", FINITE.format(n=-1),
                           restart=fast_policy(max_restarts=2,
                                               backoff_base_s=5.0))
        svc.start()
        for _ in range(10):
            svc.supervisor.notify_crash("error", "boom")
        assert svc.supervisor.snapshot()["crashes_in_window"] == 1
        assert not svc.supervisor.breaker_open

    def test_watchdog_degrades_then_restarts(self, mgr):
        svc = mgr.register(
            "staller", "tensor_src num-buffers=-1 framerate=500 "
            "dimensions=2 types=float32 ! tensor_fault drop-prob=1.0 "
            "! tensor_sink name=out", restart=fast_policy(max_restarts=50),
            watchdog_s=0.3, warmup="none")
        svc.start()
        assert wait_for(lambda: svc.supervisor.restarts >= 1)
        assert any(s == "degraded" for _, s, _ in svc.history())
        assert any(r.reason == "stall" for r in svc.supervisor.crash_reports)


# -- hot swap / canary -------------------------------------------------------

def _serving(mgr, name="svc", slot="mdl", factor=2):
    mgr.models.define(slot, {"1": f"builtin://scaler?factor={factor}"},
                      active="1")
    return mgr.register(name, FILTER_LINE.format(slot=slot)).start()


class TestModelSwap:
    def test_registry_slot_resolves_without_file(self, mgr):
        from nnstreamer_tpu_torch.registry.models import resolve

        mgr.models.define("inproc", {"1": "builtin://scaler?factor=2"},
                          active="1")
        assert resolve("registry://inproc")[0] == "builtin://scaler?factor=2"
        assert resolve("registry://inproc@1")[0] == \
            "builtin://scaler?factor=2"

    def test_identical_swap_is_byte_identical_across_flip(self, mgr):
        svc = _serving(mgr)
        mgr.models.add_version("mdl", "2", "builtin://scaler?factor=2")
        out = svc.pipeline.get("out")
        assert mgr.models.swap("mdl", "2") == {"slot": "mdl", "version": "2",
                                              "flipped": 1}
        assert wait_for(lambda: out.buffer_count >= 10)
        svc.drain(timeout_s=10)
        firsts = []
        while True:
            b = out.pull(timeout=0.2)
            if b is None:
                break
            a = np.asarray(b.tensors[0])
            np.testing.assert_array_equal(a, np.full(4, a[0], np.float32))
            firsts.append(float(a[0]))
        assert firsts == [2.0 * i for i in range(len(firsts))]

    def test_swap_changes_model_without_restart(self, mgr):
        svc = _serving(mgr)
        gen = svc.generation
        mgr.models.add_version("mdl", "2", "builtin://scaler?factor=3")
        mgr.models.swap("mdl", "2")
        assert svc.generation == gen and svc.state is ServiceState.READY
        out = svc.pipeline.get("out")

        def tripled():
            b = out.pull(timeout=1.0)
            v = float(np.asarray(b.tensors[0])[0])
            return v != 0 and v % 3 == 0
        assert wait_for(tripled, timeout=10)

    def test_failed_warmup_rolls_back(self, mgr):
        svc = _serving(mgr)
        mgr.models.add_version("mdl", "broken", "builtin://no_such_model")
        with pytest.raises(SwapError, match="rolled back"):
            mgr.models.swap("mdl", "broken")
        assert mgr.models.info("mdl")["active"] == "1"
        assert svc.state is ServiceState.READY
        a = np.asarray(svc.pipeline.get("out").pull(timeout=2.0).tensors[0])
        np.testing.assert_array_equal(a, (a / 2) * 2)
        with pytest.raises(KeyError):
            mgr.models.swap("mdl", "404")

    def test_canary_split_equals_the_reference_router(self, mgr):
        """The same invoke sequence through the port's router and the
        reference's picks the same backend at every step."""
        from nnstreamer_tpu.service.models import _CanaryBackend as RRouter
        from nnstreamer_tpu_torch.service.models import _CanaryBackend

        class Tag:
            def __init__(self, tag):
                self.tag = tag

            def invoke(self, inputs):
                return [self.tag]
        for fraction in (0.1, 0.25, 0.5, 0.3):
            p = _CanaryBackend(Tag("p"), Tag("c"), fraction)
            r = RRouter(Tag("p"), Tag("c"), fraction)
            got = [p.invoke([])[0] for _ in range(97)]
            assert got == [r.invoke([])[0] for _ in range(97)]
            assert p.routing_stats() == r.routing_stats()

    def test_canary_splits_then_promotes(self, mgr):
        svc = _serving(mgr)
        mgr.models.add_version("mdl", "2", "builtin://scaler?factor=3")
        mgr.models.canary("mdl", "2", fraction=0.5)
        assert wait_for(lambda: mgr.models.info("mdl")["canary"]
                        ["canary_invokes"] >= 4)
        c = mgr.models.info("mdl")["canary"]
        assert c["version"] == "2"
        assert abs(c["canary_invokes"] - c["primary_invokes"]) <= 1
        mgr.models.promote_canary("mdl")
        assert mgr.models.info("mdl")["active"] == "2"
        assert "canary" not in mgr.models.info("mdl")
        svc.drain(timeout_s=10)

    def test_canary_cancel_restores_primary(self, mgr):
        svc = _serving(mgr)
        mgr.models.add_version("mdl", "2", "builtin://scaler?factor=5")
        mgr.models.canary("mdl", "2", fraction=0.3)
        mgr.models.cancel_canary("mdl")
        info = mgr.models.info("mdl")
        assert "canary" not in info and info["active"] == "1"
        out = svc.pipeline.get("out")
        n = out.buffer_count  # frames invoked before the cancel arrive
        assert wait_for(lambda: out.buffer_count >= n + 3)  # in order
        for _ in range(1024):  # drop what the canary window stored
            if out.pull(timeout=0) is None:
                break
        vals = [float(np.asarray(out.pull(timeout=2.0).tensors[0])[0])
                for _ in range(8)]
        assert all(v % 2 == 0 for v in vals)  # the primary (x2) only


# MobileNet-v2 at width 0.35 on 32x32 frames: two weight sets of the
# reference's model (its seed, and that tree with every leaf scaled by a
# seeded factor in [0.8, 1.2]), carried into the
# port's filter_model_u8 and named by the slot as MODULE:V1 / MODULE:V2
V1 = V2 = None


@pytest.fixture(scope="module")
def mobilenet_pair():
    fn, params = jbuild(width_mult=0.35, compute_dtype="float32")
    tree1 = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(1)
    tree2 = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.8, 1.2, a.shape)).astype(a.dtype), tree1)
    jfn = jax.jit(fn)
    mod = sys.modules[MODULE]
    for name, tree in (("V1", tree1), ("V2", tree2)):
        setattr(mod, name, make_u8_entry(dataclasses.replace(
            tmb.filter_model, width_mult=0.35, params=tree)))

    def ref(tree, frames):
        x = jnp.asarray(frames.astype(np.float32) * (1.0 / 127.5) - 1.0)
        return np.asarray(jfn(jax.tree_util.tree_map(jnp.asarray, tree), x))
    return tree1, tree2, ref


def test_mobilenet_swap_mid_stream_matches_the_reference(mgr,
                                                         mobilenet_pair):
    """Frames stream through a registry://mnet service while the slot
    swaps v1 → v2: every answer is the reference's v1 or v2 forward on
    its frame, v1 answers come first, and after the swap only v2."""
    tree1, tree2, ref = mobilenet_pair
    caps = "other/tensors,format=static,dimensions=3:32:32:2,types=uint8"
    mgr.models.define("mnet", {"1": f"{MODULE}:V1", "2": f"{MODULE}:V2"},
                      active="1")
    svc = mgr.register(
        "mnet", f"appsrc name=in caps={caps} ! tensor_filter framework=torch "
        "accelerator=cpu model=registry://mnet name=f ! tensor_sink name=out "
        "max-stored=64", warmup="none").start()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
              for _ in range(8)]
    outs = []
    svc.pipeline.get("out").connect(lambda b: outs.append(
        np.asarray(b.as_numpy().tensors[0])))
    src = svc.pipeline.get("in")
    for k, f in enumerate(frames):
        if k == 4:
            assert mgr.models.swap("mnet", "2")["flipped"] == 1
        src.push_buffer(f)
        assert wait_for(lambda: len(outs) > k, timeout=30)
    versions = []
    for f, got in zip(frames, outs):
        w1, w2 = ref(tree1, f), ref(tree2, f)
        d1, d2 = np.abs(got - w1).max(), np.abs(got - w2).max()
        assert min(d1, d2) <= LOGIT_ATOL
        assert max(d1, d2) > 100 * LOGIT_ATOL  # the versions differ
        versions.append(1 if d1 < d2 else 2)
    assert versions == [1] * 4 + [2] * 4


# -- health snapshot ---------------------------------------------------------

class TestHealth:
    def test_snapshot_shape(self, mgr):
        snap = mgr.register("s", FINITE.format(n=-1)).start().status()
        assert snap["state"] == "ready" and snap["ready"] and snap["live"]
        assert snap["sink_buffers"] >= 1
        assert snap["supervisor"]["policy"] == "on-failure"
        assert "latency" in snap

    def test_snapshot_surfaces_queue_drops(self, mgr):
        svc = mgr.register(
            "lossy", "tensor_src num-buffers=-1 framerate=0 dimensions=2 "
            "types=float32 pattern=counter ! queue max-size-buffers=2 "
            "leaky=downstream name=q ! tensor_fault delay-prob=1.0 "
            "delay-ms=4 ! tensor_sink name=out max-stored=16").start()
        assert wait_for(lambda: svc.status()["queue_dropped_total"] > 0)
        snap = svc.status()
        q = snap["elements"]["q"]
        assert q["dropped_downstream"] > 0
        assert q["leaky"] == "downstream" and q["capacity"] == 2
        assert snap["queue_dropped_total"] >= q["dropped_downstream"]

    def test_serving_metrics_in_snapshot(self, mgr):
        svc = mgr.register(
            "batched", SRC + "! tensor_serving framework=torch "
            "accelerator=cpu model=builtin://scaler?factor=2 "
            "bucket-sizes=1,2,4 ! tensor_sink name=out max-stored=16"
        ).start()

        def served():
            s = svc.status().get("serving", {})
            return s and any(x["completed"] > 0 for x in s.values())
        assert wait_for(served)
        (sched,) = svc.status()["serving"].values()
        assert sched["completed"] > 0 and sched["compile_count"] >= 1


# -- query-server attach -----------------------------------------------------

@pytest.mark.timeout_s(60)
def test_tcp_clients_share_the_service_batch(mgr):
    from nnstreamer_tpu_torch.core import Buffer, Caps
    from nnstreamer_tpu_torch.query.client import QueryClient

    mgr.register(
        "q", "appsrc name=in caps=other/tensors,format=static,dimensions=4,"
        "types=float32 ! tensor_serving framework=torch accelerator=cpu "
        "model=builtin://scaler?factor=2 ! tensor_sink name=out",
        warmup="none").start()
    svc = mgr.get("q")
    server = svc.attach_query_server()
    c = QueryClient("127.0.0.1", server.port)
    try:
        c.connect(Caps.new("other/tensors"))
        c.send(Buffer([np.full((1, 4), 3.0, np.float32)]))
        out = c.responses.get(timeout=30)
        np.testing.assert_array_equal(np.asarray(out.tensors[0]),
                                      np.full((1, 4), 6.0, np.float32))
    finally:
        c.close()
    svc.stop()  # also tears the query server down
    assert svc._query_server is None


def test_concurrent_scheduler_requests_make_one_scheduler(monkeypatch):
    """Negotiation (the source's thread) and a query-server attach (the
    caller's) both ask a tensor_serving element for its scheduler first:
    one scheduler is made, and stop closes it (the attach in the case
    above raced negotiation and leaked the other's thread)."""
    import threading

    from nnstreamer_tpu_torch.elements.serving import TensorServing
    from nnstreamer_tpu_torch.registry.elements import make_element

    el = make_element("tensor_serving", model="builtin://scaler?factor=2",
                      accelerator="cpu")
    made, gate = [], threading.Barrier(2)
    orig = TensorServing._make_scheduler

    def slow_make(self):
        made.append(threading.current_thread().name)
        time.sleep(0.2)  # hold the window open for the other caller
        return orig(self)
    monkeypatch.setattr(TensorServing, "_make_scheduler", slow_make)
    got = []

    def ask():
        gate.wait(5)
        got.append(el._ensure_scheduler())
    ts = [threading.Thread(target=ask, name=f"ask{i}") for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert len(made) == 1 and len(got) == 2 and got[0] is got[1]
    el.stop()
    assert got[0]._thread is None  # closed, its thread joined


# -- HTTP control surface ----------------------------------------------------

@pytest.mark.timeout_s(60)
class TestControlApi:
    @pytest.fixture
    def ctl(self, mgr):
        server = ControlServer(mgr).start()
        yield ControlClient(server.endpoint)
        server.stop()

    def test_register_start_status_stop_over_http(self, mgr, ctl):
        assert ctl.healthz()["ok"]
        out = ctl.register(name="web", launch=FINITE.format(n=-1))
        assert out == {"name": "web", "state": "registered"}
        assert ctl.start("web")["state"] == "ready"
        snap = ctl.status("web")
        assert snap["ready"] and snap["sink_buffers"] >= 1
        assert ctl.drain("web")["state"] == "stopped"
        assert ctl.list()["services"][0]["state"] == "stopped"
        ctl.unregister("web")
        assert ctl.list()["services"] == []

    def test_http_swap_models_and_metrics(self, mgr, ctl):
        from nnstreamer_tpu_torch.obs import promtext

        mgr.models.define("m", {"1": "builtin://scaler?factor=2",
                                "2": "builtin://scaler?factor=3"},
                          active="1")
        mgr.register("s", FILTER_LINE.format(slot="m")).start()
        assert ctl.models()["slots"]["m"]["active"] == "1"
        assert ctl.swap("m", "2")["flipped"] == 1
        assert ctl.models()["slots"]["m"]["active"] == "2"
        text = ctl.metrics_text()
        assert promtext.sample(text, "nns_service_up", {"service": "s"}) == 1

    def test_http_admission_rejection_and_unknown_service(self, mgr, ctl):
        with pytest.raises(ServiceError, match="admission lint"):
            ctl.register(name="bad",
                         launch="tensor_src ! tensor_flter ! tensor_sink")
        with pytest.raises(ServiceError, match="unknown"):
            ctl.status("ghost")


# -- fusion under the service plane (reference tests/test_fusion.py) --------

def test_canary_router_defuses_and_promote_refuses(mgr):
    """A canary router is not fused around: the segment defuses for the
    canary window (so the canary gets its share) and re-fuses after
    promote."""
    mgr.models.define("cslot", {"1": "builtin://scaler?factor=2"},
                      active="1")
    svc = mgr.register(
        "canary-fused", "tensor_src num-buffers=-1 framerate=400 "
        "dimensions=4 types=float32 pattern=counter ! tensor_transform "
        "mode=arithmetic option=add:0 accelerator=cpu ! tensor_filter "
        "framework=torch accelerator=cpu model=registry://cslot name=f ! "
        "tensor_sink name=out max-stored=64").start()
    assert wait_state(svc, ServiceState.READY)
    (seg,) = svc.pipeline.fused_segments
    assert wait_for(lambda: seg.stats["dispatches"] >= 3)
    mgr.models.add_version("cslot", "2", "builtin://scaler?factor=2")
    mgr.models.canary("cslot", "2", 0.5)
    router = svc.pipeline.get("f").backend
    assert wait_for(lambda: router.canary_invokes >= 3)
    assert seg.stats["defused"] >= 1
    mgr.models.promote_canary("cslot")
    d0 = seg.stats["dispatches"]
    assert wait_for(lambda: seg.stats["dispatches"] > d0)


def test_supervised_restart_and_registry_swap_not_stale(mgr):
    """A tensor_fault crash triggers a supervised restart, then a
    registry:// hot swap: neither serves a stale fused callable (values
    track the active model)."""
    mgr.models.define("fmodel", {"1": "builtin://scaler?factor=2"},
                      active="1")
    svc = mgr.register(
        "fused-crash-swap", "tensor_src num-buffers=200 framerate=400 "
        "dimensions=4 types=float32 pattern=counter ! tensor_transform "
        "mode=arithmetic option=add:0 accelerator=cpu ! tensor_filter "
        "framework=torch accelerator=cpu model=registry://fmodel name=f ! "
        "tensor_fault name=flt crash-at-buffer=12 ! tensor_sink name=out "
        "max-stored=512",
        restart=RestartPolicy(mode="on-failure", backoff_base_s=0.05,
                              jitter=0.0))
    svc.start()
    assert wait_for(lambda: svc.supervisor.restarts >= 1, timeout=20)
    assert svc.supervisor.restarts == 1
    assert wait_for(lambda: svc.pipeline.fused_segments and
                    svc.pipeline.fused_segments[0].stats["dispatches"] > 0)
    out = svc.pipeline.get("out")
    mgr.models.add_version("fmodel", "2", "builtin://scaler?factor=5")
    mgr.models.swap("fmodel", "2")
    n = out.buffer_count
    wait_for(lambda: out.buffer_count >= n + 10
             or svc.state is not ServiceState.READY)
    vals = []
    for _ in range(512):
        b = out.pull(timeout=0.2)
        if b is None:
            break
        vals.append(float(np.asarray(b.tensors[0])[0]))
    assert vals
    assert all(v % 2.0 == 0.0 or v % 5.0 == 0.0 for v in vals)
    assert any(v != 0.0 and v % 5.0 == 0.0 and v % 2.0 != 0.0 for v in vals)
