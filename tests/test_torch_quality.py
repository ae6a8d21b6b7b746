"""Tensor-health taps, drift scoring and the quality gates
(obs/quality.py): the port against nnstreamer_tpu.

The reduce is held on the same seeded inputs. Integer counts (NaN, Inf,
zeros, finite) and min/max are exact. Moments: in float32 the sum is
within 1e-5 of the sum of |v| and the sum of squares within rtol 1e-5;
in bfloat16 both packages sum in bfloat16, and the test measures the gap
and holds it to one bfloat16 rounding step of the sum.

Histogram buckets are ``ceil(log2|v|)`` clipped to [-32, 31], where the
reference has two reducers that disagree with each other on planted
values:
* its host reduce (numpy) takes a float32 ``np.log2``;
* its device reduce is ``jnp.log2`` = ``log(x) / log(2)`` in the input's
  dtype, and XLA's float32 quotient misbuckets some values within two
  ulps of a power of two (2^-13 and 2^-15 exactly, among others).
The port's float32 buckets equal the host reduce on every value and the
device reduce on every value but those. Its bfloat16
buckets take the reference's quotient and equal the device reduce on
every value. ``torch.frexp`` gives the exact bucket; it matches neither
reference reducer where float32 rounds log2 (one or two ulps above 2^k)
nor the bfloat16 quotient, which the last reduce test shows.

Launch lines run through both packages (the reference without segment
fusion, which the port has not got yet): same stages, kinds and integer
cells; the host bfloat16 buffer is untapped in both."""
import json
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import flight as jflight
from nnstreamer_tpu.obs import quality as jquality
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.obs import flight as tflight
from nnstreamer_tpu_torch.obs import metrics as tmetrics
from nnstreamer_tpu_torch.obs import quality as tquality
from nnstreamer_tpu_torch.runtime.parse import parse_launch

CHAIN = ("tensor_src name=src num-buffers={n} dimensions=8 types={types} "
         "pattern=counter {fault}"
         "! tensor_transform name=t1 mode=arithmetic option=add:-3 {acc}"
         "! tensor_transform name=t2 mode=arithmetic option=mul:0.5 {acc}"
         "! queue name=q ! tensor_sink name=out max-stored=512")
FILTER = ("tensor_src name=src num-buffers={n} dimensions=4:2 types={types} "
          "pattern=random {fault}! tensor_filter name=f framework={fw} {acc}"
          "model=builtin://scaler?factor=3 ! tensor_sink name=out")
LM = ("appsrc name=in caps=other/tensors,format=static,dimensions=6:4,"
      "types=int32 ! tensor_filter name=f framework={fw} {acc}"
      "model={pkg}.models.lm_serving:tiny ! tensor_sink name=out")


@pytest.fixture(autouse=True)
def _clean_quality_plane():
    before = len(tsan.violations())
    for mod in (tquality, jquality):
        mod.stop()
        mod.reset()
        mod.clear_baseline()
    yield
    for mod in (tquality, jquality):
        mod.stop()
        mod.reset()
        mod.clear_baseline()
    assert tsan.violations()[before:] == []


def _fmt(line, port, **kw):
    kw.setdefault("fault", "")
    kw.setdefault("types", "float32")
    if port:
        return line.format(acc="accelerator=cpu ", fw="torch",
                           pkg="nnstreamer_tpu_torch", **kw)
    return line.format(acc="", fw="jax", pkg="nnstreamer_tpu", **kw)


# ---------------------------------------------------------------------------
# the reduce
# ---------------------------------------------------------------------------

def _planted() -> np.ndarray:
    """Zeros, values at and below MIN_VALUE, NaN, ±Inf, and every power
    of two in the clipped range with 1-2 ulps either side."""
    vals = [0.0, -0.0, 1e-12, 1e-9, -1e-9, 2e-9, np.nan, np.nan, np.inf,
            -np.inf]
    for k in range(-34, 34):
        p = np.float32(2.0 ** k)
        lo = hi = p
        vals += [p, -p]
        for _ in range(2):
            lo = np.nextafter(lo, np.float32(0))
            hi = np.nextafter(hi, np.float32(np.inf))
            vals += [lo, hi, -hi]
    return np.array(vals, np.float32)


def _random(n=20000, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = rng.choice([1e-6, 1e-3, 1.0, 30.0, 1e4], n)
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _split(r):
    elems, ivec, fvec, counts = r
    return int(elems), np.asarray(ivec, np.int64), \
        np.asarray(fvec, np.float64), np.asarray(counts, np.int64)


def _check_f32_moments(got, want, a):
    """sum within 1e-5 of sum|v|, sumsq within rtol 1e-5, min/max exact."""
    fin = a[np.isfinite(a)].astype(np.float64)
    assert abs(got[0] - want[0]) <= 1e-5 * max(np.abs(fin).sum(), 1e-30)
    assert got[1] == pytest.approx(want[1], rel=1e-5, abs=1e-30)
    assert got[2] == want[2] and got[3] == want[3]


def _buckets_ref_jit(x):
    return np.asarray(jax.jit(lambda v: jnp.ceil(jnp.log2(v)))(x)
                      ).astype(np.float64)


def _buckets_port(t):
    return torch.ceil(tquality._log2(t)).double().numpy()


@pytest.mark.parametrize("case", ["planted", "random", "int", "empty"])
def test_f32_reduce_matches_reference_host_reduce(case):
    a = {"planted": _planted(), "random": _random(),
         "int": np.arange(-300, 300, dtype=np.int32),
         "empty": np.zeros((0, 3), np.float32)}[case]
    got = _split(tquality._reduce_any(torch.from_numpy(a)))
    want = _split(jquality._reduce_np(a))
    assert got[0] == want[0]
    assert (got[1] == want[1]).all()
    assert (got[3] == want[3]).all()
    _check_f32_moments(got[2], want[2], a.astype(np.float32))
    # the port's host path IS the reference's
    host = _split(tquality._reduce_np(a))
    for x, y in zip(host[1:], want[1:]):
        assert (x == y).all()


@pytest.mark.parametrize("case", ["planted", "random", "int"])
def test_f32_device_reduce_vs_reference_device_reduce(case):
    """Counts exact; buckets equal except within two ulps of the powers
    of two XLA's float32 log(x)/log(2) misbuckets, where the port equals
    the reference's own host reduce."""
    a = {"planted": _planted(), "random": _random(),
         "int": np.arange(-300, 300, dtype=np.int32)}[case]
    got = _split(tquality._reduce_any(torch.from_numpy(a)))
    want = _split(jquality._reduce_any(jnp.asarray(a)))
    assert got[0] == want[0] and (got[1] == want[1]).all()
    _check_f32_moments(got[2], want[2], a.astype(np.float32))
    live = np.abs(a[np.isfinite(a)]).astype(np.float32)
    live = live[live > tquality.MIN_VALUE]
    port_b = _buckets_port(torch.from_numpy(live))
    ref_b = _buckets_ref_jit(jnp.asarray(live))
    host_b = np.ceil(np.log2(live)).astype(np.float64)
    differ = live[port_b != ref_b].astype(np.float64)
    # only values within two ulps of a power of two
    near = 2.0 ** np.round(np.log2(differ))
    assert (np.abs(differ / near - 1) < 3 * 2.0 ** -24 * 2).all(), differ
    assert (port_b == host_b).all()
    if case == "planted":
        assert len(differ) > 0
    else:
        assert len(differ) == 0
        assert (got[3] == want[3]).all()


@pytest.mark.parametrize("case", ["planted", "random"])
def test_bf16_device_reduce_matches_reference(case):
    """bfloat16 on the device path: counts and histogram exact; both
    packages sum in bfloat16, and the measured gap stays within one
    bfloat16 rounding step of the sum."""
    a = _planted() if case == "planted" else _random(50000, seed=1)
    ref_x = jnp.asarray(a).astype(jnp.bfloat16)
    port_x = torch.from_numpy(np.asarray(ref_x).astype(np.float32)).to(
        torch.bfloat16)
    packed = tquality._torch_reduce(port_x).numpy()
    got = (a.size, packed[:5].astype(np.int64), packed[5:9],
           packed[9:].astype(np.int64))
    want = _split(jquality._reduce_any(ref_x))
    assert (got[1] == want[1]).all()
    assert (got[3] == want[3]).all()
    assert got[2][2] == want[2][2] and got[2][3] == want[2][3]
    for i in (0, 1):
        # one bfloat16 step (8 significant bits) at the sum's magnitude
        step = 2.0 ** math.ceil(math.log2(abs(want[2][i]) or 1.0)) / 128
        assert abs(got[2][i] - want[2][i]) <= step, (i, got[2], want[2])


def test_which_bucket_rule_matches_the_reference():
    """float32: ``torch.log2`` == the host reduce on every planted value;
    the exact bucket (``torch.frexp``) differs from it one or two ulps
    above 2^k for |k| >= 4, where float32 rounds log2 to k. bfloat16: the
    reference's quotient matches the device reduce on every value,
    ``torch.log2`` and frexp do not."""
    live = np.abs(_planted())
    live = live[np.isfinite(live) & (live > tquality.MIN_VALUE)]
    t = torch.from_numpy(live)
    mant, exp = torch.frexp(t)
    exact = (exp - (mant == 0.5).to(exp.dtype)).double().numpy()
    port_b = _buckets_port(t)
    host_b = np.ceil(np.log2(live)).astype(np.float64)
    assert (port_b == host_b).all()
    off = live[exact != host_b]
    assert len(off) > 0
    k = np.floor(np.log2(off.astype(np.float64)))
    assert (np.abs(k) >= 4).all()
    assert ((off.astype(np.float64) / 2.0 ** k - 1) < 3 * 2.0 ** -23).all()

    b = _random(50000, seed=2)
    b = np.abs(b[b != 0])
    ref_x = jnp.asarray(b).astype(jnp.bfloat16)
    port_x = torch.from_numpy(np.asarray(ref_x).astype(np.float32)).to(
        torch.bfloat16)
    ref_b = _buckets_ref_jit(ref_x)
    assert (_buckets_port(port_x) == ref_b).all()
    mant, exp = torch.frexp(port_x.float())
    exact = (exp - (mant == 0.5).to(exp.dtype)).double().numpy()
    log2_b = torch.ceil(torch.log2(port_x)).double().numpy()
    assert (exact != ref_b).sum() > 0 and (log2_b != ref_b).sum() > 0


def test_host_bfloat16_is_not_tapped_in_either_package():
    a = np.arange(8, dtype=np.float32)
    assert jquality._reduce_any(a.astype(ml_dtypes.bfloat16)) is None
    assert tquality._reduce_any(torch.from_numpy(a).to(torch.bfloat16)) \
        is None
    # a float32 CPU tensor is a device-path tensor (a filter's output)
    assert tquality._reduce_any(torch.from_numpy(a)) is not None


def test_psi_and_cells_match():
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(512).astype(np.float32) * s
          for s in (1.0, 1.0, 4.0)]
    port = [tquality.TensorHealth() for _ in xs]
    ref = [jquality.TensorHealth() for _ in xs]
    for cell, x in zip(port, xs):
        cell.fold(*tquality._reduce_np(x))
    for cell, x in zip(ref, xs):
        cell.fold(*jquality._reduce_np(x))
    for i in range(3):
        for j in range(3):
            assert tquality.psi(port[i].hist, port[j].hist) == \
                jquality.psi(ref[i].hist, ref[j].hist)
    assert tquality.psi(port[0].hist, port[1].hist) < 0.1
    assert tquality.psi(port[0].hist, port[2].hist) > 0.25
    assert tquality.psi(port[0].hist, tquality.TensorHealth().hist) == 0.0
    for p, r in zip(port, ref):
        assert p.to_cell() == r.to_cell()
        assert p.snapshot() == r.snapshot()
        assert tquality.TensorHealth.from_cell(r.to_cell()).to_cell() == \
            p.to_cell()
    merged_p = tquality.merge_cells(port[0].to_cell(), port[2].to_cell())
    merged_r = jquality.merge_cells(ref[0].to_cell(), ref[2].to_cell())
    assert merged_p == merged_r and merged_p["buffers"] == 0


# ---------------------------------------------------------------------------
# taps on launch lines
# ---------------------------------------------------------------------------

def _tap_run(mod, line, sample_every=1, feed=None):
    mod.start(sample_every=sample_every)
    try:
        # per-edge taps: both packages unfused
        pipe = (lambda s: parse_launch(s, fuse=False) if mod is tquality
                else jax_parse_launch(s, fuse=False))(line)
        pipe.play()
        if feed is not None:
            src = pipe.get("in")
            for x in feed:
                src.push_buffer(x)
            src.end_of_stream()
        msg = pipe.wait(timeout=120)
        pipe.stop()
        assert msg.type.value == "eos", msg
    finally:
        mod.stop()
    return mod.accountant().stages()


_EXACT = ("kind", "buffers", "elems", "nan", "inf", "zero", "finite",
          "min", "max")


def _same_cells(got, want, line_types="float32"):
    assert set(got) == set(want)
    for name in got:
        g, w = got[name], want[name]
        for f in _EXACT:
            assert g[f] == w[f], (name, f, g[f], w[f])
        assert g["hist"] == w["hist"], name
        fin = max(abs(w["min"] or 0), abs(w["max"] or 0)) * w["finite"]
        assert abs(g["sum"] - w["sum"]) <= 1e-5 * max(fin, 1e-30)
        assert g["sumsq"] == pytest.approx(w["sumsq"], rel=1e-5)


@pytest.mark.parametrize("types", ["float32", "int32", "uint8"])
@pytest.mark.parametrize("sample_every", [1, 3])
def test_chain_taps_match(types, sample_every):
    got = _tap_run(tquality, _fmt(CHAIN, True, n=12, types=types),
                   sample_every)
    want = _tap_run(jquality, _fmt(CHAIN, False, n=12, types=types),
                    sample_every)
    _same_cells(got, want)
    assert set(got) == {"pipeline:t1", "pipeline:t2", "pipeline:q",
                        "pipeline:out"}
    assert got["pipeline:out"]["buffers"] == -(-12 // sample_every)


def test_filter_output_taps_match():
    """The filter's output is a device-path tensor in both packages (a
    jax array there, a CPU torch tensor here): tapped by the device
    reduce in both."""
    got = _tap_run(tquality, _fmt(FILTER, True, n=6))
    want = _tap_run(jquality, _fmt(FILTER, False, n=6))
    _same_cells(got, want)
    assert got["pipeline:out"]["elems"] == 6 * 8


def test_lm_filter_line_taps_match():
    feed = [np.arange(24, dtype=np.int32).reshape(4, 6) % 50]
    got = _tap_run(tquality, _fmt(LM, True), feed=feed)
    jfeed = [np.array(x) for x in feed]
    want = _tap_run(jquality, _fmt(LM, False), feed=jfeed)
    # prompts equal; tokens of random weights differ between the
    # packages' inits, so the output edge is held on its integer shape
    assert got["pipeline:f"] == want["pipeline:f"]
    assert got["pipeline:out"]["elems"] == want["pipeline:out"]["elems"]
    assert got["pipeline:out"]["nan"] == 0


def test_host_bfloat16_line_untapped_in_both():
    line = ("tensor_src name=src num-buffers=4 dimensions=8 types=bfloat16 "
            "pattern=counter ! queue name=q ! tensor_sink name=out")
    assert _tap_run(tquality, line) == _tap_run(jquality, line) == {}


def test_taps_off_record_nothing():
    assert not tquality.ACTIVE
    parse_launch(_fmt(CHAIN, True, n=4)).run(timeout=60)
    assert tquality.accountant().stages() == {}


def test_byte_parity_tapped_vs_off():
    def run_collect(tapped):
        if tapped:
            tquality.start(sample_every=2)
        try:
            pipe = parse_launch(_fmt(CHAIN, True, n=10))
            outs = []
            pipe.get("out").connect(
                lambda b: outs.append([np.asarray(t).tobytes()
                                       for t in b.as_numpy().tensors]))
            pipe.run(timeout=60)
        finally:
            tquality.stop()
        return outs

    plain, tapped = run_collect(False), run_collect(True)
    assert len(plain) == 10 and plain == tapped


def test_serving_tap_is_sampled():
    tquality.ACTIVE = True  # the scheduler hook's gate
    try:
        tquality.SAMPLE_EVERY = 2
        for _ in range(6):
            tquality.observe_outputs("serving:test-sched",
                                     [torch.ones(8)])
    finally:
        tquality.stop()
        tquality.SAMPLE_EVERY = 8
    cell = tquality.accountant().stages()["serving:test-sched"]
    assert cell["kind"] == "serving" and cell["buffers"] == 3


def test_tensor_serving_line_feeds_the_serving_series():
    stages = _tap_run(tquality, (
        "tensor_src num-buffers=4 dimensions=3:1 types=float32 pattern=ones "
        "! tensor_serving name=sv framework=torch accelerator=cpu "
        "model=builtin://scaler?factor=2 bucket-sizes=1,2,4 "
        "! tensor_sink name=out"))
    serving = [n for n, c in stages.items() if c["kind"] == "serving"]
    assert len(serving) == 1 and serving[0].startswith("serving:")
    assert stages[serving[0]]["min"] == 2.0


# ---------------------------------------------------------------------------
# NaN/Inf detection and drift scoring
# ---------------------------------------------------------------------------

def _nonfinite_events(flight, stage):
    return [e for e in flight.dump(category="quality")
            if e["name"] == "nonfinite" and e["data"]["stage"] == stage]


def test_nan_injection_fires_one_flight_event_like_the_reference():
    fault = "! tensor_fault name=flt nan-at-buffer=2 "
    got = _tap_run(tquality, _fmt(CHAIN, True, n=8, fault=fault))
    want = _tap_run(jquality, _fmt(CHAIN, False, n=8, fault=fault))
    assert {k: (v["nan"], v["buffers"]) for k, v in got.items()} == \
        {k: (v["nan"], v["buffers"]) for k, v in want.items()}
    assert got["pipeline:t1"]["nan"] == 6 * 1  # 1/16 span of 8 = 1 value
    ev = _nonfinite_events(tflight, "pipeline:t1")
    jev = _nonfinite_events(jflight, "pipeline:t1")
    assert len(ev) == len(jev) == 1
    assert ev[-1]["data"] == jev[-1]["data"]
    assert ev[-1]["pipeline"] == "pipeline"
    text = tmetrics.render()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("nns_quality_nan_total")
                and "pipeline:t1" in ln)
    assert float(line.rsplit(" ", 1)[1]) == 6


def _score_sequence(mod):
    mod.start(sample_every=1)
    acc = mod.accountant()
    rng = np.random.default_rng(9)
    base = [rng.standard_normal(256).astype(np.float32) for _ in range(4)]
    for x in base:
        acc.observe("p:edge", [x])
    mod.set_baseline({"edge": acc.stages()["p:edge"]}, drift_threshold=0.25)
    out = [mod.worst_score(), mod.worst_score()]
    acc.observe("p:edge", [base[0] * 16])          # drifted
    out.append(mod.score_tick())
    acc.observe("p:edge", [base[1]])               # back to normal
    out.append(mod.score_tick())
    acc.observe("p:edge", [np.full(64, np.nan, np.float32)])
    out.append(mod.worst_score(consumer="slo:a"))
    out.append(mod.worst_score(consumer="slo:b"))
    out.append(mod.worst_score(consumer="slo:a"))
    out.append(mod.drift_scores())
    out.append(mod.baseline_stages())
    snap = mod.snapshot()
    snap["stages"] = {k: {f: v for f, v in row.items()
                          if f not in ("mean", "variance")}
                      for k, row in snap["stages"].items()}
    out.append(snap)
    kinds = [e["name"] for e in (tflight if mod is tquality else jflight)
             .dump(category="quality") if e["data"].get("stage") == "p:edge"]
    out.append(kinds[-3:])
    return out


def test_drift_scoring_sequence_matches():
    got, want = _score_sequence(tquality), _score_sequence(jquality)
    assert got == want
    assert got[2]["p:edge"] > 0.25 and got[3]["p:edge"] < 0.25
    assert got[4] == got[5] == tquality.NONFINITE_SCORE and got[6] == 0.0


def test_set_baseline_does_not_rescore_ticked_history():
    tquality.start(sample_every=1)
    acc = tquality.accountant()
    acc.observe("p:edge", [np.full(16, np.nan, np.float32)])
    assert tquality.worst_score() == tquality.NONFINITE_SCORE
    assert tquality.worst_score() == 0.0
    tquality.set_baseline({}, drift_threshold=0.25)
    acc.observe("p:edge", [np.ones(16, np.float32)])
    assert tquality.worst_score() == 0.0


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [None, False, True, {},
                                 {"max_divergence": 0.5, "min_samples": 2},
                                 {"max_divergence": 0.0}, 7])
def test_quality_gate_config_forms_match(cfg):
    def run(mod):
        try:
            g = mod.QualityGate.from_config(cfg)
        except ValueError as e:
            return ("error", str(e))
        return None if g is None else g.spec()

    assert run(tquality) == run(jquality)


def _canary(mod, canary_scale, nan=False, fail=False):
    gate = mod.QualityGate(min_samples=4, mirror_every=2)
    cq = mod.CanaryQuality(gate)
    rng = np.random.default_rng(5)
    for _ in range(8):
        x = rng.standard_normal(128).astype(np.float32)
        mirror = cq.should_mirror()
        cq.observe_primary([x])
        y = x * canary_scale
        if nan:
            y[:3] = np.nan
        cq.observe_canary([y], mirrored=mirror)
    if fail:
        cq.mirror_failed(RuntimeError("candidate exploded"))
    ok, reason, rep = cq.verdict()
    return ok, reason, rep


@pytest.mark.parametrize("scale,nan,fail", [(1.0, False, False),
                                            (40.0, False, False),
                                            (1.0, True, False),
                                            (1.0, False, True)])
def test_canary_verdicts_match(scale, nan, fail):
    assert _canary(tquality, scale, nan, fail) == \
        _canary(jquality, scale, nan, fail)


@pytest.mark.parametrize("cand,base", [(None, None),
                                       ({"rate": 0.5, "rounds": 4}, None),
                                       ({"rate": 0.5, "rounds": 32}, None),
                                       ({"rate": 0.3, "rounds": 32},
                                        {"rate": 0.6, "rounds": 64}),
                                       ({"rate": 0.01, "rounds": 32}, None)])
def test_spec_acceptance_gate_matches(cand, base):
    def run(mod):
        g = mod.SpecAcceptanceGate(min_rate=0.05)
        return g.verdict(cand, base), g.spec()

    assert run(tquality) == run(jquality)


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

def test_render_section_and_snapshot_shape_match():
    def snap(mod):
        acc = mod.QualityAccountant()
        acc.observe("p:a", [np.arange(-4, 12, dtype=np.float32)])
        acc.observe("p:b", [np.zeros(8, np.float32)], kind="serving")
        return {"active": True, "sample_every": 4,
                "stages": acc.snapshots(), "drift": {"p:a": 0.5}}

    got, want = snap(tquality), snap(jquality)
    assert got == want
    assert tquality.render_section(got) == jquality.render_section(want)
    assert tquality.render_section({}) == []
    assert set(tquality.snapshot()) == set(jquality.snapshot())
    json.dumps(tquality.export_state())
