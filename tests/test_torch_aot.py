"""The AOT plane of the port (nnstreamer_tpu_torch/aot, the torch-export
backend, the nns:: kernel ops) held against nnstreamer_tpu's (aot/, the
stablehlo backend) case by case, after tests/test_aot.py: both packages
run the same lines and calls on the same inputs, and the port's outputs,
counters and verdicts must equal the reference's.

The reference's ``TestExport::test_static_fallback_when_poly_rejected``
fails in nnstreamer_tpu itself (jax lowers the reshape symbolically), so
the port's static fallback is held to its own contract there.

The ops' cases export each ``nns::`` op, save it, and load it in a fresh
interpreter (one subprocess for the four): the loaded graph holds the
op's node and gives the plain version's output. Card cases are in
tests/test_torch_aot_cuda.py.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu import aot as r_aot
from nnstreamer_tpu.runtime.parse import parse_launch as r_parse_launch
from nnstreamer_tpu_torch import aot
from nnstreamer_tpu_torch.runtime.parse import parse_launch

ROOT = Path(__file__).resolve().parents[1]

SRC = ("tensor_src num-buffers=6 dimensions=8 types=float32 "
       "pattern=counter ")
ADD = "tensor_transform mode=arithmetic option=add:1 "
R_SCALER = "tensor_filter framework=jax model=builtin://scaler?factor=2 "
SCALER = ("tensor_filter framework=torch accelerator=cpu "
          "model=builtin://scaler?factor=2 ")
R_FUSED_LINE = (SRC + f"! {ADD}! {R_SCALER}! tensor_sink name=out "
                "max-stored=16")
FUSED_LINE = (SRC + f"! {ADD}accelerator=cpu ! {SCALER}! tensor_sink "
              "name=out max-stored=16")


@pytest.fixture
def cache_root(tmp_path, monkeypatch):
    """A fresh env-configured compile cache for both packages (each
    keeps its own file extension in the directory); the reference's XLA
    cache and the port's kernel-library directory are detached
    afterwards."""
    from nnstreamer_tpu.aot import cache as r_cache_mod
    from nnstreamer_tpu_torch.ops import build

    root = tmp_path / "aotcache"
    monkeypatch.setenv(aot.CACHE_ENV, str(root))
    monkeypatch.delenv(aot.CACHE_MAX_ENV, raising=False)
    aot.reset_stats()
    r_aot.reset_stats()
    yield root
    import jax

    jax.config.update("jax_compilation_cache_dir", None)
    r_cache_mod._xla_attached = None
    build._attached = None


def pull_bytes(pipe, name="out"):
    out = pipe.get(name)
    vals = []
    while True:
        b = out.pull(timeout=0.2)
        if b is None:
            return vals
        vals.append(tuple(np.ascontiguousarray(np.asarray(t)).tobytes()
                          for t in b.tensors))


def stats_of(pipe):
    return [{k: s.stats[k] for k in ("aot_hits", "aot_exports")}
            for s in pipe.fused_segments]


# ---------------------------------------------------------------------------
# export: one shape-poly artifact covers every batch
# ---------------------------------------------------------------------------

class TestExport:
    def test_poly_artifact_one_trace_covers_buckets(self):
        traces = []

        def model(x):
            traces.append(1)
            return (x * 2.0,)

        blob, meta, _ = aot.export_stage(
            model, (torch.ones(2, 8),), poly=True)
        r_blob, r_meta, _ = r_aot.export_stage(
            lambda x: (x * 2.0,), (np.ones((2, 8), np.float32),), poly=True)
        assert meta["poly"] is r_meta["poly"] is True
        assert meta["in_avals"] == r_meta["in_avals"] == [
            {"shape": ["b", 8], "dtype": "float32"}]
        assert meta["out_avals"] == r_meta["out_avals"]
        assert meta["batch_range"][0] <= 1 and meta["batch_range"][1] is None
        n_traces = len(traces)
        loaded = aot.load_artifact(blob)
        r_loaded = r_aot.load_artifact(r_blob)
        assert loaded.poly is r_loaded.poly is True
        rng = np.random.default_rng(0)
        for bucket in (1, 2, 4, 8, 16):
            x = rng.standard_normal((bucket, 8)).astype(np.float32)
            out = loaded.call(torch.from_numpy(x))
            want = np.asarray(r_loaded.call(x)[0])
            assert out[0].shape == (bucket, 8)
            np.testing.assert_array_equal(out[0].numpy(), want)
        assert len(traces) == n_traces  # no trace after the export

    @pytest.mark.parametrize("example", [1, 2, 4])
    def test_poly_artifact_covers_batches_1_2_4(self, example):
        """A batch-1 example does not specialize the symbolic batch (the
        trace runs with backed_size_oblivious): whatever the example,
        one artifact serves batches 1, 2 and 4."""
        blob, meta, _ = aot.export_stage(
            lambda x: (x + 1,), (torch.zeros(example, 3),), poly=True)
        assert meta["poly"] is True
        loaded = aot.load_artifact(blob)
        r_blob, _, _ = r_aot.export_stage(
            lambda x: (x + 1,), (np.zeros((2, 3), np.float32),), poly=True)
        r_loaded = r_aot.load_artifact(r_blob)
        for b in (1, 2, 4):
            x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
            assert loaded.compatible((torch.from_numpy(x),))
            np.testing.assert_array_equal(
                loaded.call(torch.from_numpy(x))[0].numpy(),
                np.asarray(r_loaded.call(x)[0]))

    def test_compatibility_contract(self):
        blob, _, _ = aot.export_stage(
            lambda x: (x + 1,), (torch.ones(2, 4),), poly=True)
        loaded = aot.load_artifact(blob)
        r_blob, _, _ = r_aot.export_stage(
            lambda x: (x + 1,), (np.ones((2, 4), np.float32),), poly=True)
        r_loaded = r_aot.load_artifact(r_blob)
        cases = [np.ones((9, 4), np.float32), np.ones((9, 5), np.float32),
                 np.ones((9, 4), np.int32), np.ones((9,), np.float32)]
        for x in cases:
            assert loaded.compatible((torch.from_numpy(x),)) == \
                r_loaded.compatible((x,))
        assert loaded.compatible((torch.ones(9, 4),))
        two = (np.ones((9, 4), np.float32),) * 2
        assert loaded.compatible(tuple(map(torch.from_numpy, two))) is \
            r_loaded.compatible(two) is False

    def test_static_fallback_when_poly_rejected(self):
        """A computation that needs the concrete batch (a fixed reshape)
        does not export with a symbolic batch: the port falls back to a
        static artifact for the observed signature (the port's contract;
        the reference's own case fails in the reference)."""
        def model(x):
            return (torch.reshape(x, (8,)),)

        blob, meta, _ = aot.export_stage(
            model, (torch.ones(2, 4),), poly=True)
        assert meta["poly"] is False
        assert meta["in_avals"] == [{"shape": [2, 4], "dtype": "float32"}]
        assert meta["batch_range"] is None
        loaded = aot.load_artifact(blob)
        assert loaded.poly is False
        assert loaded.compatible((torch.ones(2, 4),))
        assert not loaded.compatible((torch.ones(3, 4),))
        x = torch.arange(8.0).reshape(2, 4)
        np.testing.assert_array_equal(loaded.call(x)[0].numpy(),
                                      np.arange(8.0, dtype=np.float32))

    def test_export_error_when_neither_exports(self):
        def model(x):
            if float(x.sum()) > 0:  # a host read of the data
                return (x,)
            return (-x,)

        with pytest.raises(aot.ExportError, match="static"):
            aot.export_stage(model, (torch.ones(2, 4),))

    def test_fabricate_inputs_substitutes_batch(self):
        meta = {"in_avals": [{"shape": ["b", 3, 2], "dtype": "float32"},
                             {"shape": [5], "dtype": "int32"}]}
        ins = aot.fabricate_inputs(meta, batch=1)
        want = r_aot.fabricate_inputs(meta, batch=1)
        assert [(i.shape, i.dtype) for i in ins] == \
            [(w.shape, w.dtype) for w in want]
        assert ins[0].shape == (1, 3, 2) and ins[0].dtype == np.float32
        bf = aot.fabricate_inputs(
            {"in_avals": [{"shape": ["b", 4], "dtype": "bfloat16"}]}, 2)
        assert bf[0].dtype is torch.bfloat16 and tuple(bf[0].shape) == (2, 4)


# ---------------------------------------------------------------------------
# the cache: roundtrip, corruption, GC
# ---------------------------------------------------------------------------

class TestCompileCache:
    KEY = {"topology": "t0", "caps": "c", "model_version": "1",
           "device": "cpu", "torch": "x"}
    R_KEY = {"topology": "t0", "caps": "c", "model_version": "1",
             "device": "cpu:8", "jax": "x"}

    def _one(self, root):
        cache = aot.CompileCache(str(root))
        blob, meta, _ = aot.export_stage(
            lambda x: (x * 3.0,), (torch.ones(2, 4),))
        cache.save(self.KEY, "s0", "d0", blob, meta)
        r_cache = r_aot.CompileCache(str(root))
        r_blob, r_meta, _ = r_aot.export_stage(
            lambda x: (x * 3.0,), (np.ones((2, 4), np.float32),))
        r_cache.save(self.R_KEY, "s0", "d0", r_blob, r_meta)
        return cache, r_cache

    def test_roundtrip_hit_and_miss(self, cache_root):
        cache, r_cache = self._one(cache_root)
        loaded = cache.load(self.KEY, "s0", "d0")
        r_loaded = r_cache.load(self.R_KEY, "s0", "d0")
        x = np.random.default_rng(1).standard_normal((5, 4)).astype(
            np.float32)
        np.testing.assert_array_equal(
            loaded.call(torch.from_numpy(x))[0].numpy(),
            np.asarray(r_loaded.call(x)[0]))
        assert cache.load({**self.KEY, "model_version": "2"},
                          "s0", "d0") is None
        assert cache.load(self.KEY, "s0", "OTHER") is None
        assert r_cache.load({**self.R_KEY, "model_version": "2"},
                            "s0", "d0") is None
        assert r_cache.load(self.R_KEY, "s0", "OTHER") is None
        assert aot.STATS == r_aot.STATS == {
            "hits": 1, "misses": 2, "exports": 1, "evictions": 0}
        assert cache.path_for(self.KEY, "s0", "d0").endswith(".pt2")

    @pytest.mark.parametrize("damage", ["blob", "meta"])
    def test_corrupt_artifact_evicts(self, cache_root, damage):
        """Flipped blob bytes (sha mismatch) or a torn meta write: the
        load misses, never crashes, and the artifact is quarantined — in
        both packages alike."""
        cache, r_cache = self._one(cache_root)
        (path,) = [e["path"] for e in cache.list()]
        (r_path,) = [e["path"] for e in r_cache.list()]
        for p, ext in ((path, ".pt2"), (r_path, ".jaxexport")):
            if damage == "blob":
                with open(p, "r+b") as fh:
                    fh.seek(10)
                    fh.write(b"\xde\xad\xbe\xef")
            else:
                with open(p[:-len(ext)] + ".meta.json", "w") as fh:
                    fh.write('{"kind": "nns-aot", "sch')
        assert cache.load(self.KEY, "s0", "d0") is None
        assert r_cache.load(self.R_KEY, "s0", "d0") is None
        assert not os.path.exists(path) and not os.path.exists(r_path)
        assert aot.STATS == r_aot.STATS
        assert aot.STATS["evictions"] == 1 and aot.STATS["misses"] == 1

    def test_lru_prune_and_env_bound(self, cache_root, monkeypatch):
        removed = {}
        for mod, key, make in (
                (aot, self.KEY, lambda: aot.export_stage(
                    lambda x: (x,), (torch.ones(1, 2),))),
                (r_aot, self.R_KEY, lambda: r_aot.export_stage(
                    lambda x: (x,), (np.ones((1, 2), np.float32),)))):
            cache = mod.CompileCache(str(cache_root))
            blob, meta, _ = make()
            for i in range(3):
                k = {**key, "topology": f"t{i}"}
                cache.save(k, "s", "d", blob, meta)
                now = time.time() + i
                os.utime(cache.path_for(k, "s", "d"), (now, now))
            gone = cache.prune(2)
            assert len(gone) == 1 and "t0" in gone[0]
            assert len(cache.list()) == 2
            removed[mod.__name__] = [os.path.basename(p).split("-")[1]
                                     for p in gone]
            monkeypatch.setenv(mod.CACHE_MAX_ENV, "1")
            bounded = mod.default_cache()
            assert bounded.max_artifacts == 1
            bounded.save({**key, "topology": "t9"}, "s", "d", blob, meta)
            assert len(bounded.list()) == 1
            monkeypatch.delenv(mod.CACHE_MAX_ENV)
        assert removed["nnstreamer_tpu_torch.aot"] == \
            removed["nnstreamer_tpu.aot"] == ["t0"]
        assert aot.STATS == r_aot.STATS

    def test_evict_by_key(self, cache_root):
        cache, r_cache = self._one(cache_root)
        assert cache.evict(self.KEY, "s0", "d0") is \
            r_cache.evict(self.R_KEY, "s0", "d0") is True
        assert cache.list() == [] and r_cache.list() == []
        assert cache.evict(self.KEY, "s0", "d0") is \
            r_cache.evict(self.R_KEY, "s0", "d0") is False

    def test_save_lock_excludes_concurrent_writer(self, cache_root):
        blob, meta, _ = aot.export_stage(
            lambda x: (x * 3.0,), (torch.ones(2, 4),))
        r_blob, r_meta, _ = r_aot.export_stage(
            lambda x: (x * 3.0,), (np.ones((2, 4), np.float32),))
        os.makedirs(str(cache_root), exist_ok=True)
        for mod, key, b, m in ((aot, self.KEY, blob, meta),
                               (r_aot, self.R_KEY, r_blob, r_meta)):
            cache = mod.CompileCache(str(cache_root))
            path = cache.path_for(key, "s0", "d0")
            open(path + ".lock", "w").close()  # another writer mid-save
            cache.save(key, "s0", "d0", b, dict(m))
            assert not os.path.exists(path)
            assert mod.STATS["exports"] == 0  # skipped, not counted
            past = time.time() - 2 * cache._LOCK_STALE_S
            os.utime(path + ".lock", (past, past))
            cache.save(key, "s0", "d0", b, dict(m))
            assert os.path.exists(path)
            assert not os.path.exists(path + ".lock")
            assert cache.load(key, "s0", "d0") is not None
        assert aot.STATS == r_aot.STATS

    def test_device_signature_and_library_dir(self, cache_root):
        from nnstreamer_tpu_torch.ops import build

        assert aot.device_signature() == (
            "cpu" if not torch.cuda.is_available()
            else aot.device_signature())
        assert aot.attach_xla_cache() is True
        assert build._attached == Path(os.path.abspath(cache_root)) / "xla"


# ---------------------------------------------------------------------------
# fused-segment + singleton-filter load paths
# ---------------------------------------------------------------------------

class TestPipelineIntegration:
    def test_fused_export_then_hit_with_byte_parity(self, cache_root):
        runs = {}
        for name, parse, line in (("port", parse_launch, FUSED_LINE),
                                  ("ref", r_parse_launch, R_FUSED_LINE)):
            p1 = parse(line)
            p1.run(timeout=30)
            p2 = parse(line)
            p2.run(timeout=30)
            p3 = parse(line, fuse=False)
            p3.run(timeout=30)
            runs[name] = (stats_of(p1), stats_of(p2), pull_bytes(p1),
                          pull_bytes(p2), pull_bytes(p3))
        s1, s2, b1, b2, b3 = runs["port"]
        assert s1 == runs["ref"][0] == [{"aot_hits": 0, "aot_exports": 1}]
        assert s2 == runs["ref"][1] == [{"aot_hits": 1, "aot_exports": 0}]
        assert b1 == b2 == b3 == runs["ref"][3]
        assert any(e["poly"] for e in aot.default_cache().list())

    def test_fused_mobilenet_line_export_then_hit(self, cache_root):
        """The device-resident MobileNet-v2 line (phase 20a's, CPU form
        at batch 2): the exported segment's logits equal the live
        line's bit for bit, and the hit serves the same bytes."""
        line = ("tensor_src device=true accelerator=cpu pattern=random "
                "types=uint8 dimensions=3:32:32:2 num-buffers=2 ! "
                "tensor_transform mode=arithmetic option=typecast:float32,"
                "add:-127.5,div:127.5 accelerator=cpu ! tensor_filter "
                "framework=torch accelerator=cpu model=nnstreamer_tpu_torch."
                "models.mobilenet_v2:filter_model ! queue ! tensor_sink "
                "name=out max-stored=8")
        os.environ.pop(aot.CACHE_ENV)
        live = parse_launch(line)
        live.run(timeout=120)
        os.environ[aot.CACHE_ENV] = str(cache_root)
        p1 = parse_launch(line)
        p1.run(timeout=120)
        p2 = parse_launch(line)
        p2.run(timeout=120)
        assert stats_of(p1) == [{"aot_hits": 0, "aot_exports": 1}]
        assert stats_of(p2) == [{"aot_hits": 1, "aot_exports": 0}]
        want = pull_bytes(live)
        assert len(want) == 2
        assert pull_bytes(p1) == want == pull_bytes(p2)

    @pytest.mark.parametrize("model", ["matmul?n=8", "mlp?n=8&layers=2"])
    def test_weighted_builtin_export_keeps_live_weights(self, cache_root,
                                                        model):
        """A builtin draws its weights on first use: drawn inside the
        export's trace they must be real values, the live model's, not
        a traced random op."""
        line = (SRC + f"! {ADD}accelerator=cpu ! tensor_filter "
                f"framework=torch accelerator=cpu model=builtin://{model} "
                "! tensor_sink name=out max-stored=16")
        p1 = parse_launch(line)
        p1.run(timeout=30)
        p2 = parse_launch(line)
        p2.run(timeout=30)
        assert stats_of(p1) == [{"aot_hits": 0, "aot_exports": 1}]
        assert stats_of(p2) == [{"aot_hits": 1, "aot_exports": 0}]
        os.environ.pop(aot.CACHE_ENV)
        live = parse_launch(line, fuse=False)
        live.run(timeout=30)
        want = pull_bytes(live)
        assert len(want) == 6 and pull_bytes(p1) == want == pull_bytes(p2)

    def test_lm_filter_exports_with_kernel_nodes(self, cache_root):
        """The LM entry's filter invoke (a whole generate) exports: one
        decode node a layer and step, one flash node a layer; a fresh
        backend hits and gives the live tokens at another batch."""
        from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                        FilterProperties)
        from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend
        from nnstreamer_tpu_torch.models.lm_serving import tiny

        def port():
            b = TorchBackend()
            b.open(FilterProperties(
                model="nnstreamer_tpu_torch.models.lm_serving:tiny",
                accelerator=Accelerator.CPU))
            return b
        rng = np.random.default_rng(0)
        x = rng.integers(1, tiny.cfg.vocab, (2, 6)).astype(np.int32)
        b1 = port()
        out = b1.invoke([x])[0]
        assert b1.aot_state() == "export"
        assert torch.equal(out, b1._fn(torch.from_numpy(x))[0])
        names = [str(n.target) for n in
                 b1._served[1].loaded.program.graph.nodes]
        layers, steps = tiny.cfg.layers, tiny.default_steps
        assert names.count("nns.decode_attention.default") == \
            layers * (steps - 1)
        assert names.count("nns.flash_attention.default") == layers
        b2 = port()
        x3 = rng.integers(1, tiny.cfg.vocab, (3, 6)).astype(np.int32)
        assert torch.equal(b2.invoke([x3])[0],
                           b2._fn(torch.from_numpy(x3))[0])
        assert b2.aot_state() == "hit"
        b1.close()
        b2.close()

    def test_singleton_filter_backend_export_then_hit(self, cache_root):
        from nnstreamer_tpu.backends.base import \
            FilterProperties as RProps
        from nnstreamer_tpu.backends.jax_backend import JaxBackend
        from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                        FilterProperties)
        from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

        def port(model):
            b = TorchBackend()
            b.open(FilterProperties(model=model,
                                    accelerator=Accelerator.CPU))
            return b

        def ref(model):
            b = JaxBackend()
            b.open(RProps(model=model))
            return b

        seq = [("builtin://scaler?factor=2", (2, 8)),
               ("builtin://scaler?factor=2", (4, 8)),
               ("builtin://scaler?factor=5", (2, 8))]
        opened = []
        for model, shape in seq:
            x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            b, rb = port(model), ref(model)
            opened += [b, rb]
            out = b.invoke([x])[0]
            np.testing.assert_array_equal(out.numpy(),
                                          np.asarray(rb.invoke([x])[0]))
            assert b.aot_state() == rb.aot_state()
        assert [b.aot_state() for b in opened[::2]] == \
            ["export", "hit", "export"]
        for b in opened:
            b.close()

    def test_guard_memoizes_probe(self, cache_root, monkeypatch):
        """The artifact guard's compatibility check runs once per NEW
        signature, never per frame, as the reference's does."""
        from nnstreamer_tpu.aot.export import LoadedArtifact as RLoaded
        from nnstreamer_tpu.backends.base import \
            FilterProperties as RProps
        from nnstreamer_tpu.backends.jax_backend import JaxBackend
        from nnstreamer_tpu_torch.aot.export import LoadedArtifact
        from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                        FilterProperties)
        from nnstreamer_tpu_torch.backends.torch_backend import TorchBackend

        counts = {}
        for name, cls in (("port", LoadedArtifact), ("ref", RLoaded)):
            real = cls.compatible

            def counting(self, args, real=real, name=name):
                counts[name] = counts.get(name, 0) + 1
                return real(self, args)
            monkeypatch.setattr(cls, "compatible", counting)
        b = TorchBackend()
        b.open(FilterProperties(model="builtin://scaler?factor=2",
                                accelerator=Accelerator.CPU))
        rb = JaxBackend()
        rb.open(RProps(model="builtin://scaler?factor=2"))
        seen = []
        for shape in [(2, 8)] * 4 + [(4, 8)]:
            for be in (b, rb):
                be.invoke([np.ones(shape, np.float32)])
            seen.append((counts.get("port"), counts.get("ref")))
        assert [p for p, _ in seen] == [r for _, r in seen]
        assert seen[3][0] == seen[0][0] and seen[4][0] == seen[3][0] + 1
        b.close()
        rb.close()

    def test_pt2_backend_joins_fused_segment(self, cache_root, tmp_path):
        """An artifact-loaded torch-export filter fuses; parity with the
        unfused run and with the reference's stablehlo filter holds."""
        from nnstreamer_tpu.backends.stablehlo_backend import \
            export_callable as r_export
        from nnstreamer_tpu_torch.backends.pt2_backend import \
            export_callable

        path = str(tmp_path / "quad.pt2")
        meta = export_callable(lambda x: x * 4.0,
                               [np.ones((8,), np.float32)], path)
        assert meta["poly"] is False
        r_path = str(tmp_path / "quad.jaxexport")
        r_export(lambda x: x * 4.0, [np.ones((8,), np.float32)], r_path,
                 poly=False)
        line = (SRC + f"! {ADD}accelerator=cpu ! tensor_filter "
                f"framework=torch-export accelerator=cpu model={path} ! "
                "tensor_sink name=out max-stored=16")
        fused = parse_launch(line)
        fused.run(timeout=30)
        (seg,) = fused.fused_segments
        assert seg.stats["dispatches"] > 0 and seg.stats["defused"] == 0
        plain = parse_launch(line, fuse=False)
        plain.run(timeout=30)
        r_line = (SRC + f"! {ADD}! tensor_filter framework=stablehlo "
                  f"model={r_path} ! tensor_sink name=out max-stored=16")
        ref = r_parse_launch(r_line)
        ref.run(timeout=30)
        got = pull_bytes(fused)
        assert len(got) == 6
        assert got == pull_bytes(plain) == pull_bytes(ref)

    def test_pt2_backend_auto_and_poly_batch(self, tmp_path):
        """``framework=auto`` picks the backend for a .pt2 file; a poly
        artifact serves another batch; the reference's StableHLO names
        get the typed error naming the .pt2 route."""
        from nnstreamer_tpu_torch.backends.base import FrameworkUnavailable
        from nnstreamer_tpu_torch.backends.pt2_backend import (
            StableHloBackend, export_callable)
        from nnstreamer_tpu_torch.core import MessageType

        path = str(tmp_path / "aff.pt2")
        w = torch.arange(12.0).reshape(4, 3)
        meta = export_callable(lambda x: (x @ w + 1.0,),
                               [torch.ones(2, 4)], path, poly=True)
        assert meta["poly"] is True
        line = ("tensor_src num-buffers=2 dimensions=4:3 types=float32 "
                f"pattern=counter ! tensor_filter accelerator=cpu "
                f"model={path} ! tensor_sink name=out")
        p = parse_launch(line)
        p.run(timeout=30)
        outs = pull_bytes(p)
        x = torch.zeros(3, 4)
        want = (x @ w + 1.0).numpy().tobytes()
        assert outs[0] == (want,)
        with pytest.raises(FrameworkUnavailable, match="torch-export"):
            StableHloBackend().open(None)
        bad = parse_launch(
            "tensor_src num-buffers=1 dimensions=4 types=float32 ! "
            f"tensor_filter accelerator=cpu model={tmp_path}/m.jaxexport "
            "! tensor_sink")
        bad.play()
        msg = bad.bus.wait_for((MessageType.ERROR,), timeout=10)
        bad.stop()
        assert msg is not None and ".pt2" in str(msg.data)


# ---------------------------------------------------------------------------
# the nns:: kernel ops: export, save, load in a fresh interpreter
# ---------------------------------------------------------------------------

def _op_cases():
    """(name, module, args, plain) at small shapes, CPU tensors."""
    from nnstreamer_tpu_torch.ops import (decode_attention, depthwise_fma,
                                          flash_attention, fma_gemm)

    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g)

    q, k, v = r(2, 2, 1, 8), r(2, 2, 16, 8), r(2, 2, 16, 8)
    fq, fk, fv = r(2, 2, 16, 8), r(2, 2, 16, 8), r(2, 2, 16, 8)
    a, b = r(3, 5, 7), r(7, 4)
    x, w = r(2, 6, 6, 4), r(1, 3, 3, 4)
    return {
        "decode_attention": (
            lambda q, k, v: decode_attention.decode_attention(q, k, v, 9,
                                                              block_k=8),
            (q, k, v),
            decode_attention.decode_attention_plain(q, k, v, 9, 8)),
        "flash_attention": (
            lambda q, k, v: flash_attention.flash_attention(
                q, k, v, True, 8, 8),
            (fq, fk, fv),
            flash_attention.flash_attention_plain(fq, fk, fv, True, 8, 8)),
        "fma_gemm": (
            lambda a, b: fma_gemm.fma_gemm(a, b, chains=2),
            (a, b), fma_gemm.fma_gemm_plain(a, b, 2)),
        "depthwise_fma": (
            lambda x, w: depthwise_fma.depthwise_fma(
                x, w, (1, 1), (1, 1), ((1, 1), (1, 1)), (6, 6)),
            (x, w),
            depthwise_fma.depthwise_fma_plain(
                x, w, (1, 1), (1, 1), ((1, 1), (1, 1)), (6, 6))),
    }


_LOAD_CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from nnstreamer_tpu_torch import aot
out = {}
for name in ("decode_attention", "flash_attention", "fma_gemm",
             "depthwise_fma"):
    with open(f"{sys.argv[2]}/{name}.pt2", "rb") as fh:
        loaded = aot.load_artifact(fh.read())
    args = torch.load(f"{sys.argv[2]}/{name}.args.pt")
    res = loaded.call(*args)[0]
    torch.save(res, f"{sys.argv[2]}/{name}.out.pt")
    out[name] = sorted({str(n.target) for n in loaded.program.graph.nodes
                        if n.op == "call_function"})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def loaded_ops(tmp_path_factory):
    """Every op exported and saved here, loaded in ONE fresh
    interpreter."""
    d = tmp_path_factory.mktemp("ops")
    cases = _op_cases()
    for name, (fn, args, _plain) in cases.items():
        blob, meta, _ = aot.export_stage(fn, args, poly=False)
        (d / f"{name}.pt2").write_bytes(blob)
        torch.save(args, d / f"{name}.args.pt")
    r = subprocess.run([sys.executable, "-c", _LOAD_CHILD, str(ROOT),
                        str(d)], capture_output=True, text=True,
                       timeout=300, cwd=str(d))
    assert r.returncode == 0, r.stderr[-3000:]
    nodes = json.loads(r.stdout.strip().splitlines()[-1])
    return d, cases, nodes


@pytest.mark.parametrize("name", ["decode_attention", "flash_attention",
                                  "fma_gemm", "depthwise_fma"])
def test_op_exports_and_loads_in_fresh_process(loaded_ops, name):
    d, cases, nodes = loaded_ops
    assert f"nns.{name}.default" in nodes[name]
    got = torch.load(d / f"{name}.out.pt")
    want = cases[name][2]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


def test_padded_pitch_constant_saved_dense(tmp_path):
    """A weight on a padded row pitch (fma_gemm's padded_rows) is a view
    of a larger storage: the artifact stores it dense, and the loaded
    program gives the live bits."""
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm, padded_rows

    w = padded_rows(12, 7, "cpu")
    w.copy_(torch.randn(12, 7, generator=torch.Generator().manual_seed(3)))

    def f(x):
        return (fma_gemm(x, w),)
    x = torch.randn(3, 12, generator=torch.Generator().manual_seed(4))
    blob, _, fresh = aot.export_stage(f, (x,))
    (c,) = fresh.program.constants.values()
    assert c.is_contiguous() and \
        c.untyped_storage().nbytes() == c.numel() * c.element_size()
    assert torch.equal(aot.load_artifact(blob).call(x)[0], f(x)[0])


def test_op_wrappers_stay_direct_when_eager(monkeypatch):
    """Eager callers never go through the op dispatcher (its host cost
    stays off the serving step); a trace does."""
    from nnstreamer_tpu_torch.ops import fma_gemm

    calls = []
    real = fma_gemm._fma_gemm
    monkeypatch.setattr(fma_gemm, "_fma_gemm",
                        lambda *a: calls.append("direct") or real(*a))
    a, b = torch.ones(2, 3), torch.ones(3, 2)
    fma_gemm.fma_gemm(a, b)
    assert calls == ["direct"]
    assert torch.equal(torch.ops.nns.fma_gemm(a, b, 1, 0),
                       fma_gemm.fma_gemm_plain(a, b))


def test_load_without_ops_gives_typed_error(tmp_path):
    fn, args, _ = _op_cases()["fma_gemm"]
    blob, _, _ = aot.export_stage(fn, args, poly=False)
    (tmp_path / "g.pt2").write_bytes(blob)
    child = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "for m in ('decode_attention', 'flash_attention', 'fma_gemm',\n"
        "          'depthwise_fma'):\n"
        "    sys.modules['nnstreamer_tpu_torch.ops.' + m] = None\n"
        "from nnstreamer_tpu_torch import aot\n"
        f"blob = open({str(tmp_path / 'g.pt2')!r}, 'rb').read()\n"
        "try:\n"
        "    aot.load_artifact(blob)\n"
        "except aot.ExportError as e:\n"
        "    print('TYPED', 'nns' in str(e), 'not registered' in str(e))\n")
    r = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert r.stdout.split() == ["TYPED", "True", "True"], r.stderr[-2000:]


# ---------------------------------------------------------------------------
# cache-key correctness under hot swap / canary promote
# ---------------------------------------------------------------------------

def _drain_vals(out, cap=512):
    vals = []
    for _ in range(cap):
        b = out.pull(timeout=0.2)
        if b is None:
            return vals
        vals.append(float(np.asarray(b.tensors[0])[0]))
    return vals


def _swap_run(pkg, filt):
    """One package's registry-swap run: (exports before, old artifact
    evicted, a factor-5 value seen, exports after)."""
    mgr = pkg.ServiceManager(jitter_seed=7)
    acc = "accelerator=cpu " if "torch" in filt else ""
    cache = (aot if "torch" in filt else r_aot).default_cache()
    try:
        mgr.models.define("aslot", {"1": "builtin://scaler?factor=2"},
                          active="1")
        svc = mgr.register(
            "aot-swap",
            "tensor_src num-buffers=-1 framerate=400 dimensions=4 "
            "types=float32 pattern=counter "
            f"! tensor_transform mode=arithmetic option=add:0 {acc}"
            f"! tensor_filter {filt} {acc}model=registry://aslot "
            "name=f ! tensor_sink name=out max-stored=512").start()
        deadline = time.monotonic() + 20
        (seg,) = svc.pipeline.fused_segments
        while (seg.stats["dispatches"] < 3
               and time.monotonic() < deadline):
            time.sleep(0.02)
        before = seg.stats["aot_exports"]
        (old_path,) = [e["path"] for e in cache.list()
                       if e["stage"] != "filter"]
        mgr.models.add_version("aslot", "2", "builtin://scaler?factor=5")
        mgr.models.swap("aslot", "2")
        evicted = not os.path.exists(old_path)
        out = svc.pipeline.get("out")
        n = out.buffer_count
        while (out.buffer_count < n + 10
               and time.monotonic() < deadline):
            time.sleep(0.02)
        vals = _drain_vals(out)
        seen5 = any(v != 0.0 and v % 5.0 == 0.0 and v % 2.0 != 0.0
                    for v in vals)
        return before, evicted, seen5, seg.stats["aot_exports"]
    finally:
        mgr.shutdown()


def _canary_run(pkg, filt):
    mgr = pkg.ServiceManager(jitter_seed=9)
    acc = "accelerator=cpu " if "torch" in filt else ""
    try:
        mgr.models.define("cslot2", {"1": "builtin://scaler?factor=2"},
                          active="1")
        svc = mgr.register(
            "aot-canary",
            "tensor_src num-buffers=-1 framerate=400 dimensions=4 "
            "types=float32 pattern=counter "
            f"! tensor_transform mode=arithmetic option=add:0 {acc}"
            f"! tensor_filter {filt} {acc}model=registry://cslot2 "
            "name=f ! tensor_sink name=out max-stored=512").start()
        deadline = time.monotonic() + 20
        (seg,) = svc.pipeline.fused_segments
        while (seg.stats["dispatches"] < 3
               and time.monotonic() < deadline):
            time.sleep(0.02)
        exports_before = seg.stats["aot_exports"]
        mgr.models.add_version("cslot2", "2", "builtin://scaler?factor=3")
        mgr.models.canary("cslot2", "2", 0.5)
        router = svc.pipeline.get("f").backend
        while (router.canary_invokes < 2
               and time.monotonic() < deadline):
            time.sleep(0.02)
        mgr.models.promote_canary("cslot2")
        d0 = seg.stats["dispatches"]
        while (seg.stats["dispatches"] <= d0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        time.sleep(0.1)
        vals = _drain_vals(svc.pipeline.get("out"))
        tail = [v for v in vals[-5:] if v != 0.0]
        promoted = bool(tail) and all(v % 3.0 == 0.0 for v in tail)
        return exports_before, promoted, \
            seg.stats["aot_exports"] > exports_before
    finally:
        mgr.shutdown()


class TestHotSwapKeying:
    def test_registry_swap_misses_old_key_never_stale(self, cache_root):
        from nnstreamer_tpu import service as r_service
        from nnstreamer_tpu_torch import service

        got = _swap_run(service, "framework=torch")
        want = _swap_run(r_service, "framework=jax")
        assert got == want == (1, True, True, 2)

    def test_canary_promote_misses_old_key(self, cache_root):
        from nnstreamer_tpu import service as r_service
        from nnstreamer_tpu_torch import service

        got = _canary_run(service, "framework=torch")
        want = _canary_run(r_service, "framework=jax")
        assert got == want and got[1:] == (True, True)


# ---------------------------------------------------------------------------
# replica warmup: shape-poly fabrication + skip flight event
# ---------------------------------------------------------------------------

class TestReplicaWarmup:
    def test_flexible_caps_skip_emits_flight_event(self, monkeypatch):
        monkeypatch.delenv(aot.CACHE_ENV, raising=False)
        from nnstreamer_tpu_torch.obs import flight as obs_flight
        from nnstreamer_tpu_torch.service.procreplica import _warmup_self

        _warmup_self("127.0.0.1", 1, "other/tensors,format=flexible")
        events = [e for e in obs_flight.dump(last=64)
                  if e["kind"] == "replica"
                  and e["name"] == "warmup_skipped"]
        assert events
        assert "caps not static" in events[-1]["data"]["reason"]

    def test_artifact_fabricates_warmup_inputs(self, cache_root):
        from nnstreamer_tpu.service.procreplica import \
            _aot_warmup_inputs as r_warmup
        from nnstreamer_tpu_torch.service.procreplica import \
            _aot_warmup_inputs

        pipe = parse_launch(FUSED_LINE)
        pipe.run(timeout=30)
        r_pipe = r_parse_launch(R_FUSED_LINE)
        r_pipe.run(timeout=30)
        inputs = _aot_warmup_inputs(pipe)
        want = r_warmup(r_pipe)
        assert inputs is not None and want is not None
        assert [(i.shape, i.dtype) for i in inputs] == \
            [(w.shape, w.dtype) for w in want]
        assert inputs[0].dtype == np.float32

    def test_warmup_prefers_head_stage_artifact(self, cache_root):
        from nnstreamer_tpu.service.procreplica import \
            _aot_warmup_inputs as r_warmup
        from nnstreamer_tpu_torch.service.procreplica import \
            _aot_warmup_inputs

        line = ("tensor_src num-buffers=4 dimensions=3:4 types=float32 "
                "! tensor_transform mode=arithmetic option=add:1 name=t1 "
                "{acc}! tensor_transform mode=transpose option=1:0 name=t3 "
                "{acc}! queue "
                "! tensor_transform mode=arithmetic option=mul:2 name=t4 "
                "{acc}! tensor_transform mode=arithmetic option=add:5 "
                "name=t5 {acc}! tensor_sink name=s")
        pipe = parse_launch(line.format(acc="accelerator=cpu "))
        pipe.run(timeout=30)
        r_pipe = r_parse_launch(line.format(acc=""))
        r_pipe.run(timeout=30)
        stages = {m["stage"] for m in aot.default_cache().metas()}
        assert stages == {m["stage"] for m in r_aot.default_cache().metas()}
        assert stages == {"t1..t3", "t4..t5"}
        inputs = _aot_warmup_inputs(pipe)
        want = r_warmup(r_pipe)
        # dimensions=3:4 wires (4, 3) buffers: the head t1..t3's inputs
        # are (b, 3), the transposed downstream segment's (b, 4). The
        # port's transpose (.contiguous() of a permute) guards b != 1, so
        # its artifact's range starts at 2 and the warmup batch with it
        (head,) = [m for m in aot.default_cache().metas()
                   if m["stage"] == "t1..t3"]
        assert head["poly"] is True and head["batch_range"][0] == 2
        assert want[0].shape == (1, 3)
        assert inputs is not None and inputs[0].shape == (2, 3)

    def test_flexible_replica_warms_from_artifact(self, cache_root):
        """A flexible-caps replica with an artifact of its topology warms
        up (one request through the saved program) instead of skipping:
        no ``warmup_skipped`` flight event."""
        from nnstreamer_tpu_torch.obs import flight as obs_flight
        from nnstreamer_tpu_torch.service.procreplica import _warmup_self

        stage = (f"{ADD}accelerator=cpu ! tensor_filter framework=torch "
                 "accelerator=cpu model=builtin://scaler?factor=2")
        caps = "other/tensors,format=flexible"
        line = ("tensor_query_serversrc name=qsrc id=77 port=0 "
                "caps=other/tensors,format=flexible ! "
                f"{stage} ! tensor_query_serversink id=77")
        warm = parse_launch(line)
        warm.play()
        try:
            port = _bound_port(warm)
            _query_once(port, caps)  # exports the segment's artifact
        finally:
            warm.stop()
        assert aot.STATS["exports"] == 1
        pipe = parse_launch(line)
        pipe.play()
        try:
            port = _bound_port(pipe)
            mark = len(obs_flight.dump(last=4096))
            _warmup_self("127.0.0.1", port,
                         "other/tensors,format=flexible", timeout=30,
                         pipeline=pipe)
            new = obs_flight.dump(last=4096)[mark:]
            assert not [e for e in new if e["name"] == "warmup_skipped"]
            (seg,) = pipe.fused_segments
            assert seg.stats["aot_hits"] == 1
            assert seg.stats["dispatches"] == 1
        finally:
            pipe.stop()


def _bound_port(pipe) -> int:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        port = int(getattr(pipe.get("qsrc"), "bound_port", 0) or 0)
        if port:
            return port
        time.sleep(0.01)
    raise AssertionError("query server never bound")


def _query_once(port: int, caps: str) -> None:
    from nnstreamer_tpu_torch.core import Buffer, parse_caps_string
    from nnstreamer_tpu_torch.query.client import QueryClient

    c = QueryClient("127.0.0.1", port, timeout=30)
    try:
        c.connect(parse_caps_string(caps))
        c.request(Buffer([np.ones((2, 8), np.float32)]), timeout=30)
    finally:
        c.close()


# ---------------------------------------------------------------------------
# placement-plan artifact refs + obs/lint surfaces
# ---------------------------------------------------------------------------

class TestSurfaces:
    def test_placement_plan_references_artifacts(self, cache_root):
        from nnstreamer_tpu.runtime.placement import Planner as RPlanner
        from nnstreamer_tpu_torch.runtime.placement import (PlacementPlan,
                                                            Planner)

        pipe = parse_launch(FUSED_LINE)
        pipe.run(timeout=30)
        plan = Planner().plan(pipe, artifact=Planner.NO_ARTIFACT)
        r_pipe = r_parse_launch(R_FUSED_LINE)
        r_pipe.run(timeout=30)
        r_plan = RPlanner().plan(r_pipe, artifact=RPlanner.NO_ARTIFACT)
        assert list(plan.aot) == list(r_plan.aot) and plan.aot
        stage, fname = next(iter(plan.aot.items()))
        assert any(s.stage == stage for s in plan.stages)
        assert os.path.exists(os.path.join(str(cache_root), fname))
        assert fname.endswith(".pt2")
        back = PlacementPlan.from_dict(
            json.loads(json.dumps(plan.to_dict())))
        assert back.aot == plan.aot

    def test_nnl015_reports_coverage_and_never_gates(self, cache_root):
        from nnstreamer_tpu.analysis import lint_launch as r_lint
        from nnstreamer_tpu_torch.analysis import Severity, lint_launch

        pipe = parse_launch(FUSED_LINE)
        pipe.run(timeout=30)
        r_pipe = r_parse_launch(R_FUSED_LINE)
        r_pipe.run(timeout=30)
        diags = lint_launch(FUSED_LINE)
        found = [d for d in diags if d.rule == "NNL015"]
        want = [d for d in r_lint(R_FUSED_LINE) if d.rule == "NNL015"]
        assert len(found) == len(want) == 1
        assert found[0].severity is Severity.INFO
        assert "shape-poly" in found[0].message
        assert found[0].message.split(":")[0] == want[0].message.split(":")[0]
        assert not [d for d in diags if d.severity is not Severity.INFO]

    def test_nnl015_absent_without_cache(self, monkeypatch):
        monkeypatch.delenv(aot.CACHE_ENV, raising=False)
        from nnstreamer_tpu_torch.analysis import lint_launch

        assert not [d for d in lint_launch(FUSED_LINE)
                    if d.rule == "NNL015"]

    def test_nnl008_cross_references_aot_retirement(self):
        from nnstreamer_tpu.analysis import lint_launch as r_lint
        from nnstreamer_tpu_torch.analysis import lint_launch

        line = ("tensor_src num-buffers=2 dimensions=8 types=float32 "
                "pattern=counter ! tensor_filter framework={fw} "
                "model=builtin://scaler?factor=2 invoke-dynamic=true "
                "! other/tensors,format=flexible ! tensor_filter "
                "framework={fw} model=builtin://add?value=1 "
                "! tensor_sink")
        diags = [d for d in lint_launch(line.format(fw="torch"))
                 if d.rule == "NNL008"]
        want = [d for d in r_lint(line.format(fw="jax"))
                if d.rule == "NNL008"]
        assert len(diags) == len(want) >= 1
        assert "NNS_AOT_CACHE" in diags[0].hint
        assert "docs/aot.md" in diags[0].hint

    def test_snapshot_and_top_section(self, cache_root):
        from nnstreamer_tpu.obs import profile as r_profile
        from nnstreamer_tpu_torch.obs import profile as obs_profile

        pipe = parse_launch(FUSED_LINE)
        pipe.run(timeout=30)
        r_pipe = r_parse_launch(R_FUSED_LINE)
        r_pipe.run(timeout=30)
        snap = aot.snapshot()
        r_snap = r_aot.snapshot()
        for k in ("active", "counters", "artifacts", "poly"):
            assert snap[k] == r_snap[k]
        assert snap["artifacts"] >= 1 and snap["counters"]["exports"] >= 1
        top = obs_profile.render_top({}, [], aot=snap)
        r_top = r_profile.render_top({}, [], aot=r_snap)
        assert "AOT COMPILE CACHE" in top and "AOT COMPILE CACHE" in r_top
        line = [ln for ln in top.splitlines() if "hits=" in ln]
        assert line == [ln for ln in r_top.splitlines() if "hits=" in ln]

    def test_profile_endpoint_carries_aot(self, cache_root):
        from nnstreamer_tpu_torch.service import (ControlClient,
                                                  ControlServer,
                                                  ServiceManager)

        mgr = ServiceManager()
        server = ControlServer(mgr, host="127.0.0.1", port=0).start()
        try:
            snap = ControlClient(
                f"http://127.0.0.1:{server.port}").profile()["aot"]
        finally:
            server.stop()
            mgr.shutdown()
        assert snap["active"] is True and snap["root"] == str(cache_root)

    def test_prom_counters_and_bytes_gauge(self, cache_root):
        from nnstreamer_tpu.obs import metrics as r_metrics
        from nnstreamer_tpu_torch.obs import metrics as obs_metrics

        def total(text, name):
            # a counter never incremented in this process renders no
            # sample line yet
            lines = [ln for ln in text.splitlines() if ln.startswith(name)]
            return float(lines[0].split()[-1]) if lines else 0.0

        name = "nns_aot_cache_exports_total"
        before = total(obs_metrics.render(), name)
        r_before = total(r_metrics.render(), name)
        pipe = parse_launch(FUSED_LINE)
        pipe.run(timeout=30)
        r_pipe = r_parse_launch(R_FUSED_LINE)
        r_pipe.run(timeout=30)
        text = obs_metrics.render()
        assert total(text, name) - before == \
            total(r_metrics.render(), name) - r_before == 1
        assert total(text, "nns_aot_artifact_bytes") > 0
