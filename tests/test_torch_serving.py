"""The port's continuous-batching serving layer (nnstreamer_tpu_torch/serving/,
elements/serving.py) against nnstreamer_tpu's: each case runs the same
inputs through both packages, asserts what nnstreamer_tpu's own test
asserts, and that the two give the same outputs.

* batch formation, the request queue's admission control, the one-shot
  Scheduler and the DecodeScheduler's join/retire policy (a deterministic
  toy engine) — host Python, compared exactly;
* ``ContinuousLMEngine`` at ``tiny`` on converted weights (models/
  convert.py): greedy tokens equal nnstreamer_tpu's engine's token for
  token, with ``decode_attn="xla"`` against the port's ``"dense"`` and
  ``"pallas"`` (its Pallas kernel in interpret mode) against the port's
  ``"kernel"`` (the CUDA kernel's plain version on the CPU); on
  nnstreamer_tpu's own tiny weights and on the same weights scaled up, so
  the streams are not one repeated token;
* ``tensor_serving`` — one pipeline through both packages, and two
  pipelines of the port sharing one scheduler.

Every scheduler a test starts is closed (conftest's leaked-thread
check)."""
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

import nnstreamer_tpu.serving as jsrv
import nnstreamer_tpu_torch.serving as tsrv
from nnstreamer_tpu.models import lm_serving as jlm
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.models import lm_serving as tlm
from nnstreamer_tpu_torch.runtime.parse import parse_launch

def _host(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _both(fn):
    """fn(serving package) for each package; returns (ref, port)."""
    return fn(jsrv), fn(tsrv)


def _req(srv, rows=1, cols=3, fill=0.0, **kw):
    return srv.Request((np.full((rows, cols), fill, np.float32),), **kw)


class FakeExecutor:
    """Host executor recording execution order (no model, no device)."""

    def __init__(self):
        self.compiles = 0
        self.calls = []

    def __call__(self, x):
        self.calls.append(float(np.asarray(x)[0, 0]))
        return (x * 2.0,)


# ---------------------------------------------------------------------------
# BatchFormer
# ---------------------------------------------------------------------------
class TestBatchFormer:
    def test_bucket_for_rounds_up(self):
        def run(srv):
            f = srv.BatchFormer(bucket_sizes=(1, 2, 4, 8))
            return [f.bucket_for(r) for r in (1, 2, 3, 4, 5, 8, 9)]
        ref, port = _both(run)
        assert port == ref == [1, 2, 4, 4, 8, 8, 16]

    def test_requests_never_straddle_batches(self):
        def run(srv):
            f = srv.BatchFormer(bucket_sizes=(4,), max_wait_s=0.0)
            for rows in (3, 3, 2):
                f.add(_req(srv, rows=rows))
            return [(b.rows, b.padded_rows) for b in f.take_ready(force=True)]
        ref, port = _both(run)
        assert port == ref == [(3, 4), (3, 4), (2, 4)]

    def test_stack_pads_to_bucket_and_splits_back(self):
        def run(srv):
            f = srv.BatchFormer(bucket_sizes=(4,), max_wait_s=0.0)
            f.add(_req(srv, rows=1, fill=1.0))
            f.add(_req(srv, rows=2, fill=2.0))
            (batch,) = f.take_ready(force=True)
            (stacked,) = batch.stacked_tensors()
            outs = batch.split_outputs((stacked * 10,))
            return _host(stacked), [_host(o[0]) for o in outs]
        (rs, ro), (ps, po) = _both(run)
        assert ps.shape == (4, 3) and np.all(ps[3] == 0)
        np.testing.assert_array_equal(ps, rs)
        for a, b in zip(po, ro):
            np.testing.assert_array_equal(a, b)
        assert po[1].shape == (2, 3) and np.all(po[1] == 20)

    def test_torch_rows_stack_on_their_device(self):
        f = tsrv.BatchFormer(bucket_sizes=(4,), max_wait_s=0.0)
        f.add(tsrv.Request((torch.ones(1, 3),)))
        f.add(tsrv.Request((np.full((2, 3), 2, np.float32),)))
        (batch,) = f.take_ready(force=True)
        (stacked,) = batch.stacked_tensors()
        assert isinstance(stacked, torch.Tensor) and stacked.shape == (4, 3)
        assert stacked[:, 0].tolist() == [1, 2, 2, 0]
        outs = batch.split_outputs((stacked + 1, torch.tensor(5.0)))
        assert outs[1][0].tolist() == [[3, 3, 3]] * 2
        assert float(outs[0][1]) == 5.0   # a batch-less output replicates

    def test_incompatible_shapes_never_coalesce(self):
        def run(srv):
            f = srv.BatchFormer(bucket_sizes=(8,), max_wait_s=0.0)
            f.add(_req(srv, rows=1, cols=3))
            f.add(_req(srv, rows=1, cols=5))
            return [b.bucket_key for b in f.take_ready(force=True)]
        ref, port = _both(run)
        assert port == ref and len(port) == 2 and port[0] != port[1]

    def test_idle_flushes_only_exact_bucket_boundaries(self):
        def run(srv):
            f = srv.BatchFormer(bucket_sizes=(1, 2, 4, 8), max_wait_s=60.0)
            f.add(_req(srv, rows=2))
            first = len(f.take_ready(idle=True))
            f.add(_req(srv, rows=3))
            return first, f.take_ready(idle=True)
        ref, port = _both(run)
        assert port == ref == (1, [])

    def test_max_wait_ages_pending(self):
        def run(srv):
            f = srv.BatchFormer(bucket_sizes=(8,), max_wait_s=0.01)
            f.add(_req(srv, rows=1))
            early = f.take_ready()
            within = 0.0 <= f.next_flush_in() <= 0.01
            time.sleep(0.02)
            return early, within, len(f.take_ready())
        ref, port = _both(run)
        assert port == ref == ([], True, 1)


# ---------------------------------------------------------------------------
# RequestQueue admission control
# ---------------------------------------------------------------------------
class TestRequestQueue:
    def test_priority_then_fifo(self):
        def run(srv):
            q = srv.RequestQueue(max_depth=16)
            reqs = [_req(srv, priority=p, fill=f)
                    for p, f in ((5, 1.0), (0, 2.0), (5, 3.0))]
            for r in reqs:
                q.put(r)
            return [float(q.get(timeout=0).tensors[0][0, 0])
                    for _ in range(3)]
        ref, port = _both(run)
        assert port == ref == [2.0, 1.0, 3.0]

    def test_queue_full_typed_shed(self):
        def run(srv):
            q = srv.RequestQueue(max_depth=1)
            q.put(_req(srv))
            overflow = _req(srv)
            with pytest.raises(srv.QueueFullError):
                q.put(overflow)
            return type(overflow.error).__name__, q.shed_full
        ref, port = _both(run)
        assert port == ref == ("QueueFullError", 1)

    def test_expired_at_admission(self):
        def run(srv):
            q = srv.RequestQueue(max_depth=16)
            late = _req(srv, deadline=time.monotonic() - 0.1)
            with pytest.raises(srv.DeadlineExceededError):
                q.put(late)
            return type(late.error).__name__
        ref, port = _both(run)
        assert port == ref == "DeadlineExceededError"

    def test_expired_while_queued_shed_at_pop(self):
        def run(srv):
            q = srv.RequestQueue(max_depth=16)
            doomed = _req(srv, deadline=time.monotonic() + 0.01)
            live = _req(srv)
            q.put(doomed)
            q.put(live)
            time.sleep(0.03)
            return (q.get(timeout=0) is live, doomed.done(),
                    type(doomed.error).__name__, q.shed_deadline)
        ref, port = _both(run)
        assert port == ref == (True, True, "DeadlineExceededError", 1)

    def test_predictive_shed_uses_service_ewma(self):
        def run(srv):
            out = []
            for predictive in (True, False):
                q = srv.RequestQueue(max_depth=64, est_batch_rows=1,
                                     predictive_shed=predictive)
                q.observe_service_time(10.0)
                q.put(_req(srv))
                try:
                    q.put(_req(srv, deadline=time.monotonic() + 0.5))
                    out.append("admitted")
                except srv.DeadlineExceededError:
                    out.append("shed")
            return out
        ref, port = _both(run)
        assert port == ref == ["shed", "admitted"]


# ---------------------------------------------------------------------------
# Scheduler (one-shot continuous batching)
# ---------------------------------------------------------------------------
class TestScheduler:
    def test_results_roundtrip(self):
        def run(srv):
            sched = srv.Scheduler(lambda x: (x * 2,), bucket_sizes=(1, 2, 4),
                                  max_wait_s=0.002, name="t-roundtrip")
            try:
                reqs = [sched.submit((np.full((1, 3), i, np.float32),))
                        for i in range(6)]
                return [_host(r.result(30)[0]) for r in reqs]
            finally:
                sched.close()
        ref, port = _both(run)
        for i, (a, b) in enumerate(zip(port, ref)):
            assert a.shape == (1, 3)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, i * 2.0)

    def test_same_bucket_compiles_exactly_once(self):
        def run(srv):
            sched = srv.Scheduler(lambda x: (x + 1,), bucket_sizes=(4,),
                                  max_wait_s=0.001, name="t-compile")
            try:
                for r in [sched.submit((np.ones((rows, 3), np.float32),))
                          for rows in (1, 2, 3, 1, 2, 3, 3, 2, 1)]:
                    r.result(30)
                once = sched.compile_count
                sched.submit((np.ones((1, 5), np.float32),)).result(30)
                return once, sched.compile_count
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == (1, 2)

    def test_expired_deadline_shed_never_executed(self):
        def run(srv):
            ex = FakeExecutor()
            sched = srv.Scheduler(executor=ex, bucket_sizes=(1,),
                                  max_wait_s=0.001, name="t-shed")
            try:
                with pytest.raises(srv.DeadlineExceededError):
                    sched.submit((np.ones((1, 3), np.float32),),
                                 deadline_s=-0.1)
                time.sleep(0.05)
                snap = sched.metrics_snapshot()
                return ex.calls, snap["shed_deadline"], snap["completed"]
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == ([], 1, 0)

    def test_expired_in_queue_shed_is_accounted(self):
        def run(srv):
            sched = srv.Scheduler(lambda x: (x,), bucket_sizes=(1,),
                                  max_wait_s=0.001, name="t-qshed",
                                  autostart=False)
            try:
                doomed = sched.submit((np.ones((1, 3), np.float32),),
                                      deadline_s=0.01)
                time.sleep(0.03)
                sched.start()
                with pytest.raises(srv.DeadlineExceededError):
                    doomed.result(10)
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    snap = sched.metrics_snapshot()
                    if snap["shed_deadline"] == 1:
                        break
                    time.sleep(0.005)
                return (snap["shed_deadline"], snap["submitted"],
                        snap["completed"])
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == (1, 1, 0)

    def test_priority_orders_execution(self):
        def run(srv):
            ex = FakeExecutor()
            sched = srv.Scheduler(executor=ex, bucket_sizes=(1,),
                                  max_wait_s=0.0, name="t-prio",
                                  autostart=False)
            try:
                reqs = [sched.submit((np.full((1, 3), f, np.float32),),
                                     priority=p)
                        for f, p in ((1.0, 9), (2.0, 0), (3.0, 5))]
                sched.start()
                for r in reqs:
                    r.result(30)
                return ex.calls
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == [2.0, 3.0, 1.0]

    def test_max_wait_flushes_partial_bucket(self):
        def run(srv):
            sched = srv.Scheduler(lambda x: (x,), bucket_sizes=(8,),
                                  max_wait_s=0.01, name="t-flush")
            try:
                t0 = time.monotonic()
                req = sched.submit((np.ones((1, 3), np.float32),))
                req.result(30)
                return time.monotonic() - t0 < 5.0, req.metrics["bucket"]
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == (True, 8)

    def test_per_request_metrics_and_snapshot(self):
        fields = ("enqueue_time", "queue_wait_s", "batch_id", "bucket",
                  "device_time_s", "ttft_s", "total_latency_s")

        def run(srv):
            # not the reference suite's "t-metrics": its registry
            # uniquifies names per process, and that suite asserts its own
            sched = srv.Scheduler(lambda x: (x,), bucket_sizes=(2,),
                                  max_wait_s=0.002, name="t-metrics-port")
            try:
                req = sched.submit((np.ones((1, 3), np.float32),))
                req.result(30)
                snap = sched.metrics_snapshot()
                return ([f in req.metrics for f in fields],
                        snap["submitted"], snap["completed"],
                        snap["batches"], snap["batch_occupancy"],
                        snap["total_latency"]["count"],
                        sched.name in srv.metrics_snapshot())
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == ([True] * 7, 1, 1, 1, 0.5, 1, True)

    def test_close_fails_pending_with_typed_error(self):
        def run(srv):
            sched = srv.Scheduler(lambda x: (x,), bucket_sizes=(8,),
                                  max_wait_s=60.0, name="t-close",
                                  autostart=False)
            stranded = sched.submit((np.ones((1, 3), np.float32),))
            sched.close()
            with pytest.raises(srv.SchedulerClosedError):
                stranded.result(1)
            with pytest.raises(srv.SchedulerClosedError):
                sched.submit((np.ones((1, 3), np.float32),))
            return type(stranded.error).__name__
        ref, port = _both(run)
        assert port == ref == "SchedulerClosedError"

    def test_queue_full_through_scheduler(self):
        def run(srv):
            sched = srv.Scheduler(lambda x: (x,), bucket_sizes=(4,),
                                  max_wait_s=60.0, max_depth=2,
                                  name="t-full", autostart=False)
            try:
                sched.submit((np.ones((1, 3), np.float32),))
                sched.submit((np.ones((1, 3), np.float32),))
                with pytest.raises(srv.QueueFullError):
                    sched.submit((np.ones((1, 3), np.float32),))
                return sched.metrics_snapshot()["shed_queue_full"]
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == 1

    def test_memory_guard_sheds_typed_and_releases(self):
        from nnstreamer_tpu.obs.memory import AdmissionGuard as JGuard
        from nnstreamer_tpu_torch.obs.memory import AdmissionGuard as TGuard

        def run(srv, guard):
            sched = srv.Scheduler(lambda x: (x,), bucket_sizes=(1,),
                                  max_wait_s=0.001, name="t-guard",
                                  memory_guard=guard, autostart=False)
            try:
                ok = sched.submit((np.ones((1, 12), np.float32),))
                with pytest.raises(srv.request.MemoryPressureError):
                    sched.submit((np.ones((1, 12), np.float32),))
                sched.start()
                ok.result(30)
                return (guard.inflight_bytes, guard.shed,
                        sched.metrics_snapshot()["shed_memory"])
            finally:
                sched.close()
        ref = run(jsrv, JGuard(160, watermark=1.0, overhead=2.0, name="g"))
        port = run(tsrv, TGuard(160, watermark=1.0, overhead=2.0, name="g"))
        assert port == ref == (0, 1, 1)


# ---------------------------------------------------------------------------
# DecodeScheduler — toy engine for policy
# ---------------------------------------------------------------------------
class ToyEngine:
    """Deterministic counter engine: next token = last + 1 (mod 97)."""

    def __init__(self, slots=2):
        self.slots = slots
        self.compile_count = 0
        self._tok = np.zeros(slots, np.int32)
        self.admits = []

    def admit(self, slot, tokens, steps):
        self.admits.append(slot)
        self._tok[slot] = (int(tokens[-1]) + 1) % 97
        return int(self._tok[slot])

    def step(self):
        self._tok = (self._tok + 1) % 97
        return self._tok.copy()

    def release(self, slot):
        self._tok[slot] = 0


def _expected(prompt_last, steps):
    return [(prompt_last + 1 + i) % 97 for i in range(steps)]


class TestDecodeScheduler:
    def test_join_and_early_finish(self):
        def run(srv):
            sched = srv.DecodeScheduler(ToyEngine(slots=2), name="t-decode")
            try:
                long = sched.submit(np.array([5], np.int32), steps=40)
                short = sched.submit(np.array([10], np.int32), steps=3)
                s = short.result(30)[0].tolist()
                joined = not long.done() or len(long.tokens) > 3
                return s, joined, long.result(30)[0].tolist()
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == (_expected(10, 3), True, _expected(5, 40))

    def test_retire_frees_slot_for_queued_request(self):
        def run(srv):
            sched = srv.DecodeScheduler(ToyEngine(slots=1), name="t-slot1")
            try:
                reqs = [sched.submit(np.array([seed], np.int32), steps=4)
                        for seed in (1, 20, 50)]
                outs = [r.result(30)[0].tolist() for r in reqs]
                snap = sched.metrics_snapshot()
                return outs, snap["completed"], snap["active_slots"]
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == ([_expected(s, 4) for s in (1, 20, 50)], 3, 0)

    def test_eos_retires_early(self):
        def run(srv):
            sched = srv.DecodeScheduler(ToyEngine(slots=2), name="t-eos")
            try:
                req = sched.submit(np.array([7], np.int32), steps=30,
                                   eos_id=10)
                return (req.result(30)[0].tolist(),
                        req.metrics["decode_steps"],
                        sched.metrics_snapshot()["retired_early"])
            finally:
                sched.close()
        ref, port = _both(run)
        assert port == ref == ([8, 9, 10], 3, 1)

    def test_decode_admission_control(self):
        def run(srv):
            sched = srv.DecodeScheduler(ToyEngine(slots=1), name="t-dadmit",
                                        autostart=False)
            out = []
            try:
                for kw in (dict(tokens=np.array([1], np.int32), steps=4,
                                deadline_s=-0.1),
                           dict(tokens=np.array([[1, 2]], np.int32),
                                steps=4),
                           dict(tokens=np.array([1], np.int32), steps=0)):
                    try:
                        sched.submit(**kw)
                        out.append(None)
                    except (srv.DeadlineExceededError, ValueError) as e:
                        out.append(type(e).__name__)
            finally:
                sched.close()
            return out
        ref, port = _both(run)
        assert port == ref == ["DeadlineExceededError", "ValueError",
                               "ValueError"]


# ---------------------------------------------------------------------------
# ContinuousLMEngine — real transformer parity, port vs reference engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trees():
    """nnstreamer_tpu's tiny weights (its entry's seed), and the same
    scaled 20x (weight matrices only), whose greedy streams vary."""
    tree = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jlm.tiny.cfg, seed=jlm.tiny.seed))
    varied = jax.tree_util.tree_map(
        lambda a: (a * 20).astype(a.dtype) if a.ndim == 2 else a, tree)
    return {"own": tree, "varied": varied}


def _run_decode(sched_cls, engine, prompts, steps, name):
    sched = sched_cls(engine, name=name)
    try:
        reqs = [sched.submit(p, steps=s) for p, s in zip(prompts, steps)]
        return [r.result(120)[0].tolist() for r in reqs]
    finally:
        sched.close()


class TestContinuousLMEngine:
    @pytest.mark.parametrize("weights", ["own", "varied"])
    @pytest.mark.parametrize("attn", [("xla", "dense"), ("pallas", "kernel")],
                             ids=["dense", "kernel"])
    def test_tokens_equal_reference_engine(self, trees, weights, attn):
        from nnstreamer_tpu.serving.lm_engine import (
            ContinuousLMEngine as JEngine,
        )

        ref_attn, port_attn = attn
        tree = trees[weights]
        jeng = JEngine(replace(jlm.tiny.cfg, decode_attn=ref_attn),
                       jax.tree_util.tree_map(jax.numpy.asarray, tree),
                       slots=2)
        entry = replace(tlm.tiny, cfg=replace(tlm.tiny.cfg,
                                              decode_attn=port_attn),
                        params=tree)
        teng = entry.make_continuous(slots=2, device="cpu")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (5, 3, 9)]
        steps = [8, 3, 6]
        # the second prompt joins while the first decodes and retires
        # first; the third takes its slot mid-decode
        want = _run_decode(jsrv.DecodeScheduler, jeng, prompts, steps, "t-j")
        got = _run_decode(tsrv.DecodeScheduler, teng, prompts, steps, "t-t")
        assert got == want
        if weights == "varied":
            assert len({t for s in got for t in s}) >= 4

    def test_steps_launch_once_per_layer_and_carry_stays_on_device(
            self, trees):
        entry = replace(tlm.tiny, params=trees["varied"])
        eng = entry.make_continuous(slots=3, device="cpu")
        p = np.arange(1, 6, dtype=np.int32)
        first = eng.admit(1, p, 4)
        before = eng.compile_count
        toks = [first] + [int(eng.step()[1]) for _ in range(3)]
        assert eng.compile_count == before + 1      # one step signature
        assert eng._pos.tolist() == [0, 8, 0]
        assert eng._pos_dev.tolist() == [0, 8, 0]
        assert eng._tok_dev.tolist()[1] == toks[-1]
        eng.release(1)
        assert eng.active_slots == 0 and eng._pos_dev.tolist() == [0, 0, 0]

    def test_validate_rejects_overlong(self):
        def run(make):
            eng = make()
            with pytest.raises(ValueError):
                eng.validate(np.zeros(60, np.int32), steps=10)
            return eng.slots
        assert run(lambda: tlm.tiny.make_continuous(slots=1, device="cpu")) \
            == run(lambda: jlm.tiny.make_continuous(slots=1))

    def test_mesh_is_refused(self):
        with pytest.raises(NotImplementedError):
            tlm.tiny.make_continuous(slots=1, mesh="dp=1", device="cpu")
        with pytest.raises(ValueError, match="paged=True"):
            tlm.tiny.make_continuous(slots=1, draft="ngram", device="cpu")

    def test_memory_bytes_track_the_cache(self):
        from nnstreamer_tpu_torch.obs import memory as obs_memory

        eng = tlm.tiny.make_continuous(slots=2, device="cpu")
        cfg = tlm.tiny.cfg
        want = 2 * cfg.layers * 2 * cfg.heads * cfg.max_seq * \
            cfg.head_dim * 4
        snap = eng.memory_bytes()
        assert snap["bytes"] == want and snap["kind"] == "kv_cache"
        assert snap["name"] in obs_memory.serving_bytes()


# ---------------------------------------------------------------------------
# tensor_serving element
# ---------------------------------------------------------------------------
class TestTensorServingElement:
    def _line(self, fw):
        return ("tensor_src num-buffers=3 dimensions=3:1 types=float32 "
                f"pattern=ones ! tensor_serving {fw} "
                "model=builtin://scaler?factor=2 bucket-sizes=1,2,4 "
                "max-wait-ms=2 ! tensor_sink name=out")

    def _run(self, parse, line):
        pipe = parse(line)
        got = []
        pipe.get("out").connect(got.append)
        pipe.play()
        try:
            assert pipe.wait(timeout=60).type.value == "eos"
            caps = str(pipe.get("out").sinkpad.caps)
        finally:
            pipe.stop()
        return caps, got

    def test_pipeline_roundtrip_with_metrics_meta(self):
        wcaps, want = self._run(jax_parse_launch, self._line("framework=jax"))
        gcaps, got = self._run(parse_launch,
                               self._line("framework=torch accelerator=cpu"))
        assert gcaps == wcaps
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_host(g.tensors[0]),
                                          _host(w.tensors[0]))
            np.testing.assert_allclose(_host(g.tensors[0]), 2.0)
            assert g.meta["serving"]["bucket"] in (1, 2, 4)
            assert "queue_wait_s" in g.meta["serving"]

    def test_invalid_properties_fail_at_construction(self):
        from nnstreamer_tpu.registry.elements import make_element as jmake
        from nnstreamer_tpu.runtime.element import ElementError as JErr
        from nnstreamer_tpu_torch.registry.elements import make_element
        from nnstreamer_tpu_torch.runtime.element import ElementError

        with pytest.raises(JErr):
            jmake("tensor_serving", model="builtin://scaler?factor=2",
                  bucket_sizes="0,4")
        for bad in (dict(bucket_sizes="0,4"), dict(framework="jax"),
                    dict(on_shed="maybe"), dict(accelerator="tpu")):
            with pytest.raises(ElementError):
                make_element("tensor_serving",
                             model="builtin://scaler?factor=2", **bad)

    def test_shared_key_rejects_model_mismatch(self):
        def run(srv):
            made = []

            def factory():
                s = srv.Scheduler(lambda x: (x,), bucket_sizes=(2,),
                                  name="t-shared")
                made.append(s)
                return s

            first = srv.get_shared_scheduler("t-key", factory, ("model-a",))
            try:
                same = srv.get_shared_scheduler("t-key", factory,
                                                ("model-a",)) is first
                srv.release_shared_scheduler("t-key")
                with pytest.raises(ValueError):
                    srv.get_shared_scheduler("t-key", factory, ("model-b",))
            finally:
                srv.release_shared_scheduler("t-key")
            return same, len(made)
        ref, port = _both(run)
        assert port == ref == (True, 1)

    def test_two_pipelines_share_one_batch(self):
        """Two port pipelines with one shared-key coalesce their frames
        into the scheduler's batches; every frame's output is its own.
        The streams are fed in lockstep (frame k of both, then k+1), and
        a 2-row bucket waits for a partner, so every batch mixes them."""
        line = ("appsrc name=in caps=other/tensors,format=static,"
                "dimensions=4:1,types=float32 ! tensor_serving "
                "framework=auto accelerator=cpu model=builtin://add?value=1 "
                "shared-key=t-two bucket-sizes=2 max-wait-ms=5000 "
                "! tensor_sink name=out")
        pipes = [parse_launch(line) for _ in range(2)]
        got = [[], []]
        for i, p in enumerate(pipes):
            p.get("out").connect(got[i].append)
            p.play()
        n = 6
        try:
            for k in range(n):
                for i in range(2):
                    pipes[i].get("in").push_buffer(
                        np.full((1, 4), 100 * i + k, np.float32))
                deadline = time.monotonic() + 30
                while (min(len(g) for g in got) <= k
                       and time.monotonic() < deadline):
                    time.sleep(0.002)
            for p in pipes:
                p.get("in").end_of_stream()
            for p in pipes:
                assert p.wait(timeout=60).type.value == "eos"
        finally:
            for p in pipes:
                p.stop()
        for i in range(2):
            vals = [float(_host(b.tensors[0])[0, 0]) for b in got[i]]
            assert vals == [100 * i + k + 1.0 for k in range(n)]
        ids = [[b.meta["serving"]["batch_id"] for b in g] for g in got]
        assert ids[0] == ids[1]            # frame k of both in one batch
        assert all(b.meta["serving"]["bucket"] == 2 for g in got for b in g)
