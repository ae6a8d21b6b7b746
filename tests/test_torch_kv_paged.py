"""Paged KV-cache serving in the port (serving/kv_pool.py, PagedLMEngine,
SpeculativeLMEngine): the legs of tests/test_kv_paged.py, run inside the
port and held against nnstreamer_tpu's tokens.

Weights: nnstreamer_tpu's ``tiny`` parameters (its entry's seed) with the
weight matrices scaled 20x, converted by models/convert.py, so the greedy
streams vary instead of repeating one token. The oracle for every stream
is nnstreamer_tpu's unbatched ``make_generate`` on the same weights;
greedy tokens must agree exactly.

* parity — the paged engine equals nnstreamer_tpu's tokens and the port's
  dense continuous engine, through slot churn;
* compile discipline — the chunk is the only prefill shape, so
  ``compile_count`` stays flat across prompt lengths;
* copy-on-write prefix sharing — a sharer's writes never reach the
  registered pages;
* preemption — evict-to-host then restore is byte-exact, directly and
  through DecodeScheduler under a pool too small for both streams;
* speculative decode — bursts equal target-only decoding for scripted
  acceptance patterns, the n-gram draft and the ``tiny_draft`` model;
* page lifecycle — close, deadline shed and batch failure release every
  page, and the port's own leak ledger (analysis/sanitizer.py) pairs
  every page acquire with a release.
"""
import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nnstreamer_tpu.models import decoding as jdec
from nnstreamer_tpu.models import lm_serving as jlm
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.analysis import sanitizer
from nnstreamer_tpu_torch.models import lm_serving as tlm
from nnstreamer_tpu_torch.models.convert import params_from_jax
from nnstreamer_tpu_torch.serving import (
    DecodeScheduler,
    NgramDraft,
    PagedLMEngine,
    ServingError,
    SpeculativeLMEngine,
)

SCALE = 20


@pytest.fixture
def leakcheck():
    was = sanitizer.leakcheck_enabled()
    sanitizer.enable_leakcheck()
    yield sanitizer
    if was:
        sanitizer.enable_leakcheck()
    else:
        sanitizer.disable_leakcheck()
        sanitizer.reset_leakcheck()


def _scaled(tree):
    return jax.tree_util.tree_map(
        lambda a: (a * SCALE).astype(a.dtype) if a.ndim == 2 else a, tree)


@functools.lru_cache(maxsize=None)
def _trees():
    own = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jlm.tiny.cfg, seed=jlm.tiny.seed))
    return own, _scaled(own)


def _tiny():
    """The port's tiny config and params on the CPU."""
    return tlm.tiny.cfg, params_from_jax(_trees()[1], "cpu")


@functools.lru_cache(maxsize=None)
def _ref_stream(prompt: tuple, steps: int):
    gen = jdec.make_generate(jlm.tiny.cfg)
    params = jax.tree_util.tree_map(jnp.asarray, _trees()[1])
    out = np.asarray(gen(params, jnp.asarray([prompt], jnp.int32), steps))
    return out[0, len(prompt):].tolist()


def _dense_baseline(cfg, params, prompt, steps):
    """nnstreamer_tpu's unbatched greedy decode on the same weights."""
    return _ref_stream(tuple(int(t) for t in prompt), steps)


def _decode(engine, slot, prompt, steps):
    out = [engine.admit(slot, np.asarray(prompt, np.int32), steps)]
    while len(out) < steps:
        out.append(int(engine.step()[slot]))
    engine.release(slot)
    return out


def _paged(cfg, params, slots, pages, share=False, page_size=8, chunk=16):
    return PagedLMEngine(cfg, params, slots=slots, page_size=page_size,
                         pages=pages, chunk=chunk, share_prefixes=share)


class TestPagedParity:
    def test_paged_matches_dense_token_exact(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(7)
        p1 = rng.integers(0, cfg.vocab, 11).astype(np.int32)
        p2 = rng.integers(0, cfg.vocab, 5).astype(np.int32)
        eng = _paged(cfg, params, slots=2, pages=16)
        sched = DecodeScheduler(eng, name="parity")
        try:
            r1 = sched.submit(p1, steps=9)
            r2 = sched.submit(p2, steps=4)
            got1 = np.asarray(r1.result(120)[0]).tolist()
            got2 = np.asarray(r2.result(120)[0]).tolist()
        finally:
            sched.close()
        assert got1 == _dense_baseline(cfg, params, p1, 9)
        assert got2 == _dense_baseline(cfg, params, p2, 4)
        assert eng.pool.used_pages == 0
        # the port's dense continuous engine gives the same streams
        dense = replace(tlm.tiny, params=_trees()[1]).make_continuous(
            slots=2, device="cpu")
        sched = DecodeScheduler(dense, name="parity-dense")
        try:
            r1 = sched.submit(p1, steps=9)
            r2 = sched.submit(p2, steps=4)
            assert r1.result(120)[0].tolist() == got1
            assert r2.result(120)[0].tolist() == got2
        finally:
            sched.close()

    def test_slot_churn_does_not_perturb_streams(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(11)
        eng = _paged(cfg, params, slots=1, pages=8)
        for n in (3, 17, 9):
            p = rng.integers(0, cfg.vocab, n).astype(np.int32)
            assert _decode(eng, 0, p, 6) == \
                _dense_baseline(cfg, params, p, 6)

    def test_compile_count_flat_across_prompt_lengths(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(13)
        eng = _paged(cfg, params, slots=1, pages=8)
        p = rng.integers(0, cfg.vocab, 4).astype(np.int32)
        _decode(eng, 0, p, 3)
        frozen = eng.compile_count
        for n in (1, 7, 16, 23, 40):
            p = rng.integers(0, cfg.vocab, n).astype(np.int32)
            _decode(eng, 0, p, 3)
        assert eng.compile_count == frozen, \
            "prompt length must not be a compiled shape"
        # the dense engine's prefill, by contrast, is one signature per
        # prompt length, as nnstreamer_tpu's is one trace per length
        dense = tlm.tiny.make_continuous(slots=1, device="cpu")
        for n in (3, 5, 3):
            _decode(dense, 0, np.arange(n, dtype=np.int32), 2)
        assert dense.compile_count == 3   # prefill 3, prefill 5, step


class TestPrefixSharing:
    def test_shared_prefix_hits_and_streams_stay_isolated(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(17)
        prefix = rng.integers(0, cfg.vocab, 16).astype(np.int32)
        p1 = np.concatenate([prefix, rng.integers(0, cfg.vocab, 4)
                             .astype(np.int32)])
        p2 = np.concatenate([prefix, rng.integers(0, cfg.vocab, 6)
                             .astype(np.int32)])
        eng = _paged(cfg, params, slots=2, pages=16, share=True)
        out1 = [eng.admit(0, p1, 8)]
        assert eng.pool.stats()["prefix_hits_total"] == 0
        out2 = [eng.admit(1, p2, 8)]
        assert eng.pool.stats()["prefix_hits_total"] >= 1
        assert eng.pool.shared_pages >= 2
        while len(out1) < 8:
            tok = eng.step()
            out1.append(int(tok[0]))
            out2.append(int(tok[1]))
        assert out1 == _dense_baseline(cfg, params, p1, 8)
        assert out2 == _dense_baseline(cfg, params, p2, 8)
        eng.release(0)
        eng.release(1)
        eng.close()
        assert eng.pool.used_pages == 0

    def test_sharer_writes_never_corrupt_the_registered_pages(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(19)
        prompt = rng.integers(0, cfg.vocab, 16).astype(np.int32)
        eng = _paged(cfg, params, slots=2, pages=16, share=True)
        base = _dense_baseline(cfg, params, prompt, 10)
        out1 = [eng.admit(0, prompt, 10)]
        registered = eng.slot_pages(0).clone()
        out2 = [eng.admit(1, prompt, 10)]   # identical prompt: full hit
        assert eng.pool.stats()["prefix_hits_total"] >= 1
        while len(out1) < 10:
            tok = eng.step()
            out1.append(int(tok[0]))
            out2.append(int(tok[1]))
        assert out1 == base and out2 == base
        assert eng.pool.stats()["cow_copies_total"] >= 1
        # the registry still holds the prompt's pages, byte for byte
        pages, covered = eng.pool.lookup_prefix(prompt)
        assert covered == 16
        got = torch.stack([eng._kpool[:, pages], eng._vpool[:, pages]])
        torch.testing.assert_close(got, registered[:, :, :len(pages)],
                                   rtol=0, atol=0)
        eng.pool.release(pages)
        eng.release(0)
        eng.release(1)
        eng.close()
        assert eng.pool.used_pages == 0


class TestPreemptRestore:
    def test_preempt_restore_byte_exact(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(23)
        p1 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
        p2 = rng.integers(0, cfg.vocab, 6).astype(np.int32)
        eng = _paged(cfg, params, slots=2, pages=16)
        out1 = [eng.admit(0, p1, 12)]
        out2 = [eng.admit(1, p2, 12)]
        for _ in range(4):
            tok = eng.step()
            out1.append(int(tok[0]))
            out2.append(int(tok[1]))
        used_before = eng.pool.used_pages
        held = eng.slot_pages(0).clone()
        blob = eng.preempt(0)
        assert eng.pool.used_pages < used_before
        for _ in range(3):
            out2.append(int(eng.step()[1]))
        eng.restore(0, blob)
        torch.testing.assert_close(eng.slot_pages(0), held, rtol=0, atol=0)
        while len(out1) < 12:
            tok = eng.step()
            out1.append(int(tok[0]))
            if len(out2) < 12:
                out2.append(int(tok[1]))
        assert out1 == _dense_baseline(cfg, params, p1, 12)
        assert out2 == _dense_baseline(cfg, params, p2, 12)
        eng.release(0)
        eng.release(1)
        assert eng.pool.used_pages == 0

    def test_tight_pool_preemption_through_scheduler(self):
        cfg, params = _tiny()
        p1 = (np.arange(1, 14, dtype=np.int32) % 60)
        p2 = ((np.arange(3, 23, dtype=np.int32) * 7) % 60).astype(np.int32)
        base1 = _dense_baseline(cfg, params, p1, 20)
        base2 = _dense_baseline(cfg, params, p2, 10)
        eng = _paged(cfg, params, slots=2, pages=6)
        sched = DecodeScheduler(eng, name="tight")
        try:
            r1 = sched.submit(p1, steps=20)
            r2 = sched.submit(p2, steps=10)
            o1 = np.asarray(r1.result(120)[0]).tolist()
            o2 = np.asarray(r2.result(120)[0]).tolist()
            snap = sched.metrics_snapshot()
        finally:
            sched.close()
        assert o1 == base1
        assert o2 == base2
        assert 1 <= snap["preempted"] < 50
        assert snap["restored"] == snap["preempted"]
        assert snap["shed_memory"] == 0
        assert eng.pool.used_pages == 0


class _ScriptDraft:
    """Oracle-backed draft with a scripted accuracy pattern."""

    def __init__(self, oracle, correct):
        self._oracle = oracle
        self._correct = correct
        self._round = 0

    def admit(self, slot, tokens, first):
        pass

    def propose(self, slot, hist, k):
        truth = self._oracle[slot]
        r, self._round = self._round, self._round + 1
        props = []
        for i in range(k):
            pos = len(hist) + i
            true_tok = truth[pos] if pos < len(truth) else 0
            props.append(true_tok if self._correct(r, i)
                         else (true_tok + 1) % 64)
        return props

    def commit(self, slot, emitted):
        pass

    def release(self, slot):
        pass

    def restore(self, slot, hist):
        pass


class TestSpeculativeParity:
    def _spec_stream(self, eng, prompt, steps):
        out = [eng.admit(0, np.asarray(prompt, np.int32), steps)]
        while len(out) < steps:
            out.extend(eng.step_tokens()[0])
        eng.release(0)
        return out[:steps]

    @pytest.mark.parametrize("pattern,expected_rate", [
        (lambda r, i: False, 0.0),
        (lambda r, i: True, 1.0),
        (lambda r, i: r % 2 == 0, None),
        (lambda r, i: i == 0, None),
    ], ids=["reject", "accept", "alternate", "one"])
    def test_scripted_acceptance_patterns_token_exact(self, pattern,
                                                      expected_rate):
        cfg, params = _tiny()
        rng = np.random.default_rng(29)
        prompt = rng.integers(0, cfg.vocab, 7).astype(np.int32)
        steps = 12
        base = _dense_baseline(cfg, params, prompt, steps)
        oracle = {0: [int(t) for t in prompt] + base}
        eng = SpeculativeLMEngine(_paged(cfg, params, slots=1, pages=8),
                                  _ScriptDraft(oracle, pattern), k=4)
        assert self._spec_stream(eng, prompt, steps) == base
        if expected_rate is not None:
            assert eng.acceptance_rate() == pytest.approx(expected_rate,
                                                          abs=0.05)
        eng.close()

    def test_ngram_draft_token_exact(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(31)
        prompt = rng.integers(0, cfg.vocab, 8).astype(np.int32)
        base = _dense_baseline(cfg, params, prompt, 16)
        eng = SpeculativeLMEngine(_paged(cfg, params, slots=1, pages=8),
                                  NgramDraft(), k=4)
        assert self._spec_stream(eng, prompt, 16) == base
        eng.close()

    def test_model_draft_token_exact_through_scheduler(self):
        draft = replace(tlm.tiny_draft, params=_scaled(jax.tree_util.tree_map(
            np.asarray, jtr.init_params(jlm.tiny_draft.cfg, seed=1))))
        eng = replace(tlm.tiny, params=_trees()[1]).make_continuous(
            slots=2, paged=True, draft=draft, spec_k=4, page_size=8,
            pages=16, chunk=16, share_prefixes=False, device="cpu")
        cfg, params = eng.cfg, eng.target.params
        rng = np.random.default_rng(37)
        p1 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
        p2 = rng.integers(0, cfg.vocab, 4).astype(np.int32)
        sched = DecodeScheduler(eng, name="spec-sched")
        try:
            r1 = sched.submit(p1, steps=10)
            r2 = sched.submit(p2, steps=7)
            got1 = np.asarray(r1.result(120)[0]).tolist()
            got2 = np.asarray(r2.result(120)[0]).tolist()
            snap = sched.metrics_snapshot()
        finally:
            sched.close()
        assert got1 == _dense_baseline(cfg, params, p1, 10)
        assert got2 == _dense_baseline(cfg, params, p2, 7)
        assert snap["spec_rounds"] > 0
        assert eng.pool.used_pages == 0

    def test_speculation_survives_preemption(self):
        cfg, params = _tiny()
        rng = np.random.default_rng(41)
        prompt = rng.integers(0, cfg.vocab, 8).astype(np.int32)
        steps = 14
        base = _dense_baseline(cfg, params, prompt, steps)
        target = _paged(cfg, params, slots=1, pages=8)
        eng = SpeculativeLMEngine(target, NgramDraft(), k=4)
        out = [eng.admit(0, prompt, steps)]
        out.extend(eng.step_tokens()[0])
        blob = eng.preempt(0)
        assert target.pool.used_pages == 0
        eng.restore(0, blob)
        while len(out) < steps:
            out.extend(eng.step_tokens()[0])
        assert out[:steps] == base
        eng.release(0)
        eng.close()

    def test_verify_logits_match_single_steps(self):
        """verify() scores K positions in one pass: its logits for the
        carry column equal a plain step's."""
        cfg, params = _tiny()
        a = _paged(cfg, params, slots=1, pages=8)
        b = _paged(cfg, params, slots=1, pages=8)
        prompt = np.arange(3, 12, dtype=np.int32)
        first = a.admit(0, prompt, 6)
        assert b.admit(0, prompt, 6) == first
        logits = a.verify(np.array([[first, 5, 6, 7]], np.int32))
        assert logits.shape == (1, 4, cfg.vocab)
        assert int(np.argmax(logits[0, 0])) == int(b.step()[0])


class TestPageLifecycle:
    def _engine(self, slots=2, pages=16):
        cfg, params = _tiny()
        return cfg, _paged(cfg, params, slots=slots, pages=pages)

    def test_release_on_close_with_inflight_work(self):
        cfg, eng = self._engine()
        sched = DecodeScheduler(eng, name="close-leak")
        p = np.arange(1, 10, dtype=np.int32)
        reqs = [sched.submit(p, steps=50) for _ in range(2)]
        sched.close()
        for r in reqs:
            with pytest.raises(Exception):
                r.result(timeout=5.0)
        assert eng.pool.used_pages == 0

    def test_release_on_deadline_shed(self):
        cfg, eng = self._engine(slots=1)
        sched = DecodeScheduler(eng, name="deadline-leak")
        p = np.arange(1, 8, dtype=np.int32)
        try:
            blocker = sched.submit(p, steps=40)
            late = sched.submit(p, steps=40, deadline_s=0.01)
            with pytest.raises(Exception):
                late.result(timeout=30.0)
            blocker.result(timeout=120.0)
            assert sched.metrics_snapshot()["shed_deadline"] >= 1
        finally:
            sched.close()
        assert eng.pool.used_pages == 0

    def test_release_on_batch_failure(self):
        cfg, eng = self._engine(slots=1)
        sched = DecodeScheduler(eng, name="fail-leak")
        orig_step = eng.step

        def boom():
            raise ServingError("injected device fault")

        p = np.arange(1, 8, dtype=np.int32)
        try:
            eng.step = boom
            req = sched.submit(p, steps=10)
            with pytest.raises(Exception):
                req.result(timeout=30.0)
        finally:
            eng.step = orig_step
            sched.close()
        assert eng.pool.used_pages == 0

    def test_leak_ledger_pairs_pool_acquire_release(self, leakcheck):
        cfg, eng = self._engine(slots=1, pages=8)
        sanitizer.reset_leakcheck()
        _decode(eng, 0, np.arange(1, 12, dtype=np.int32), 6)
        assert eng.pool.used_pages == 0
        assert sanitizer.outstanding("kv_page") == []
        rep = sanitizer.leak_report()
        assert rep["enabled"] and rep["outstanding_units"] == 0
        assert rep["acquired_total"]["kv_page"] >= 2

    def test_leak_ledger_flags_held_pages(self, leakcheck):
        cfg, eng = self._engine(slots=1, pages=8)
        sanitizer.reset_leakcheck()
        eng.admit(0, np.arange(1, 12, dtype=np.int32), 6)
        assert sanitizer.outstanding("kv_page")
        eng.release(0)
        assert sanitizer.outstanding("kv_page") == []
