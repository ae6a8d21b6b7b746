#!/usr/bin/env python
"""Per-element overhead microbenchmark of the port: the counterpart of
``tools/microbench_overhead.py``, and the gate of two of the package's
contracts on the port.

* **host chains** (``tensor_debug``): the pure Python pad-hop cost of one
  element (pad push → chain → transform → push);
* **device chains** (``tensor_transform mode=arithmetic option=add:1`` on
  ``--device``): the pad hop plus one dispatch per element, the cost that
  segment fusion (``runtime/fusion.py``) deletes by collapsing a linear
  device run into ONE dispatch (on the card one CUDA graph replay, on the
  CPU one composed call). Measured fused vs ``fuse=False``: the marginal
  per-element cost of an 8-element fused device chain must stay >= 3x
  lower than unfused (docs/fusion.md; ``--smoke`` gates 2x, best of two
  attempts, as the reference does).

The disabled-state gates of the observability plane's cost contract
(docs/observability.md): with a plane switched off its hooks are one
module-global check, so an 8-element chain after an enable→disable cycle
must cost within 2% of the same chain never enabled. The legs, each on
the chain its hooks sit on: tracing (chrometrace tracer + span tracing)
and the continuous profiler, NNS_LEAKCHECK's ledger (host chain); memory
accounting, the quality taps and NNS_XFERCHECK (fused device chain); the
NNS_WIREFUZZ scorekeeper (the wire codec round trip); and placement (a
fused device chain through an applied PlacementPlan against place off).
Baseline and disabled legs are measured as ADJACENT pairs, 4 a leg, and
the gate reads the MINIMUM of the per-pair ratios (the reference's
best-of-N: a structural overhead shifts every pair, a co-tenant spike
only some). Each side of a pair is the sum of ``ROUNDS`` runs of the
reference's frame count, run in turn with its partner's (baseline,
cycle, disabled, baseline, ...), so that a change of the host's speed
over a run lands on both sides; the four chains of the speedup are timed
in the same round-robin. Beside each gate the report gives the median of
the pair ratios and the noise floor of the chain it runs on: the ratios
of null pairs (the baseline against itself, measured the same way),
whose largest distance from 1 is the smallest overhead the gate can
tell from the host's noise. The enabled costs are reported alongside,
not gated. Each timed run starts with the previous runs collected and
the card idle.

``--stage-sweep`` times a 2-element fused chain on host frames of 64 B
to 256 KiB through the pinned stager and through the replay's own copy
(the choice ``runtime/fusion.py``'s ``STAGE_MIN_BYTES`` makes);
``--trace-fused`` profiles the 8-element fused chain (host and device
frames) with ``torch.profiler`` and reports the host time by call.

Usage:
  python tools/microbench_overhead_torch.py [n_frames]   # full report
  python tools/microbench_overhead_torch.py --smoke      # the gates
  ... --device cpu   --json OUT.json   --stage-sweep   --trace-fused

``--smoke`` runs each leg at the reference's frame counts scaled by
``n_frames / 4000`` (so ``200 --smoke`` is a twentieth of them). Either
form prints every gate's verdict, writes the JSON report before it exits,
and exits 1 if a gate failed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HOST_ELEM = "tensor_debug output-mode=none"
DEVICE_ELEM = "tensor_transform mode=arithmetic option=add:1 accelerator={acc}"
GATE_FRAC = 0.02
SPEEDUP_FULL, SPEEDUP_SMOKE = 3.0, 2.0
# the reference's pairs a --smoke leg and chances of the speedup gate
SMOKE_ATTEMPTS, SMOKE_SPEEDUP_ATTEMPTS = 4, 2
# runs summed into each side of a pair, in turn with the partner's
ROUNDS = 3
DEFAULT_FRAMES = 4000


def device_elem(acc: str) -> str:
    return DEVICE_ELEM.format(acc=acc)


def settle() -> None:
    """Before a timed run: the previous runs' pipelines (threads, CUDA
    graphs and their pools) collected, and the card idle, so neither
    lands inside the next window."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure(n_elems: int, n_bufs: int, elem: str = HOST_ELEM,
            fuse: bool = True, place=None, stats: Optional[list] = None,
            dims: str = "16", steady: bool = False) -> float:
    """Seconds per frame of ``tensor_src ! elem × n_elems ! tensor_sink``
    (``steady``: between the sink's arrivals after the first tenth, so
    without the run's set-up); each fused segment's host seconds a
    dispatch are appended to ``stats``."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    chain = " ! ".join([elem] * n_elems)
    pipe = parse_launch(
        f"tensor_src num-buffers={n_bufs} dimensions={dims} types=float32 "
        f"! {chain} ! tensor_sink name=out max-stored=1", fuse=fuse,
        place=place)
    arrivals: list = []
    if steady:
        pipe.get("out").connect(
            lambda _buf: arrivals.append(time.perf_counter()))
    settle()
    t0 = time.perf_counter()
    pipe.run(timeout=300)
    dt = (time.perf_counter() - t0) / n_bufs
    if steady:
        k = len(arrivals) // 10
        dt = (arrivals[-1] - arrivals[k]) / (len(arrivals) - 1 - k)
    if stats is not None:
        stats.extend(seg.stats["total_s"] / max(1, seg.stats["dispatches"])
                     for seg in pipe.fused_segments)
    return dt


def rounds(runs: dict, n_rounds: int = ROUNDS) -> dict:
    """Each named run's mean over ``n_rounds``, the runs taken in turn
    (a, b, ..., a, b, ...)."""
    total = dict.fromkeys(runs, 0.0)
    for _ in range(n_rounds):
        for name, run in runs.items():
            total[name] += run()
    return {name: t / n_rounds for name, t in total.items()}


def device_chain_report(n_bufs: int, acc: str) -> dict:
    """µs/frame of the 1- and 8-element device chains, fused and with
    ``fuse=False``, timed in turn; the marginal cost of one more element
    ((t_8 - t_1) / 7) each way, and their ratio."""
    elem = device_elem(acc)
    measure(8, max(50, n_bufs // 10), elem, True)   # warm-up: capture, caches
    dispatch: list = []
    t = rounds({
        ("unfused", 1): lambda: measure(1, n_bufs, elem, False),
        ("unfused", 8): lambda: measure(8, n_bufs, elem, False),
        ("fused", 1): lambda: measure(1, n_bufs, elem, True),
        ("fused", 8): lambda: measure(8, n_bufs, elem, True, stats=dispatch),
    })
    rep = {}
    for key in ("unfused", "fused"):
        lo, hi = t[(key, 1)], t[(key, 8)]
        rep[key] = {"n_lo": 1, "n_hi": 8,
                    "us_per_frame_lo": lo * 1e6,
                    "us_per_frame_hi": hi * 1e6,
                    "marginal_us_per_element": (hi - lo) / 7 * 1e6}
    # the one dispatch of the fused 8-element chain: host µs inside it
    # (inputs, replay, output clones, fence)
    rep["fused"]["dispatch_host_us_8"] = (
        statistics.mean(dispatch) * 1e6 if dispatch else None)
    # a fused chain is one dispatch whatever its length: its marginal can
    # measure ~0 or slightly negative (noise), so floor it at 0.1 µs
    denom = max(rep["fused"]["marginal_us_per_element"], 0.1)
    rep["speedup_marginal"] = \
        rep["unfused"]["marginal_us_per_element"] / denom
    return rep


def paired(run_a, run_b, n_bufs: int, attempts: int, between=None):
    """``attempts`` adjacent pairs: each side the mean of ``ROUNDS`` runs
    of ``n_bufs`` frames, a and b in turn (``between`` runs before every
    b). Returns both sides' seconds a frame, pair by pair."""
    a_s, b_s = [], []
    for _ in range(attempts):
        ta = tb = 0.0
        for _ in range(ROUNDS):
            ta += run_a(n_bufs)
            if between is not None:
                between()
            tb += run_b(n_bufs)
        a_s.append(ta / ROUNDS)
        b_s.append(tb / ROUNDS)
    return a_s, b_s


def noise_floor(run, n_bufs: int, attempts: int) -> dict:
    """Null pairs: the baseline against itself, measured as a gate's
    pairs are; the largest distance of their ratios from 1 is the
    smallest overhead a gate on this chain can tell from noise."""
    run(max(200, n_bufs // 4))  # warm-up
    a_s, b_s = paired(run, run, n_bufs, attempts)
    ratios = [b / a for a, b in zip(a_s, b_s)]
    return {"pair_ratios": [round(r, 4) for r in ratios],
            "median": statistics.median(ratios) - 1.0,
            "floor": max(abs(r - 1.0) for r in ratios)}


def three_state_report(run, enable, disable, n_bufs: int,
                       attempts: int) -> dict:
    """The three-state protocol: ``baseline`` (not enabled since its last
    cycle; never, in the first run), ``enabled`` (reported, in the first
    cycle) and ``disabled`` (right after an enable→disable cycle: gated
    against its paired baseline, minimum of the pair ratios)."""
    run(max(200, n_bufs // 4))  # warm-up: imports, registries, allocations
    enabled = []

    def cycle():
        enable()
        try:
            if not enabled:
                enabled.append(run(n_bufs))
        finally:
            disable()

    baselines, disableds = paired(run, run, n_bufs, attempts, cycle)
    ratios = [d / b for b, d in zip(baselines, disableds)]
    baseline = min(baselines)
    return {
        "n_frames": n_bufs,
        "attempts": attempts,
        "rounds": ROUNDS,
        "baseline_us_per_frame": baseline * 1e6,
        "enabled_us_per_frame": enabled[0] * 1e6,
        "disabled_us_per_frame": min(disableds) * 1e6,
        "pair_ratios": [round(r, 4) for r in ratios],
        "disabled_overhead_frac": min(ratios) - 1.0,
        "disabled_overhead_frac_median": statistics.median(ratios) - 1.0,
        "enabled_overhead_frac": enabled[0] / baseline - 1.0,
    }


def host_chain(n: int) -> float:
    return measure(8, n)


def tracing_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """Chrometrace tracer + obs span tracing on the 8-element host chain."""
    from nnstreamer_tpu_torch.obs import context as obs_context
    from nnstreamer_tpu_torch.utils import trace as nns_trace

    path = os.path.join(tempfile.gettempdir(), "nns_overhead_trace_torch.json")

    def enable():
        nns_trace.install_tracer(nns_trace.ChromeTraceTracer(path=path))
        obs_context.enable_tracing()

    def disable():
        nns_trace.uninstall_tracers()
        obs_context.disable_tracing()
        obs_context.reset()

    return three_state_report(host_chain, enable, disable, n_bufs, attempts)


def profiler_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """The continuous profiler (element tracer, queue/fused/request hooks)
    on the 8-element host chain."""
    from nnstreamer_tpu_torch.obs import profile as obs_profile

    def disable():
        obs_profile.stop()
        obs_profile.reset()

    return three_state_report(host_chain, obs_profile.start, disable,
                              n_bufs, attempts)


def leakcheck_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """NNS_LEAKCHECK's ledger on the 8-element host chain (the pad-hop path
    carries no leakcheck hook by construction)."""
    from nnstreamer_tpu_torch.analysis import sanitizer as san

    def disable():
        san.disable_leakcheck()
        san.reset_leakcheck()

    return three_state_report(host_chain, san.enable_leakcheck, disable,
                              n_bufs, attempts)


def _device_chain(acc: str):
    elem = device_elem(acc)
    return lambda n: measure(8, n, elem)


def memory_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """Memory accounting (hooks on the fused dispatch and the filter
    invoke) on the 8-element fused device chain."""
    from nnstreamer_tpu_torch.obs import memory as obs_memory

    def disable():
        obs_memory.stop()
        obs_memory.reset()

    return three_state_report(_device_chain(acc), obs_memory.start, disable,
                              n_bufs, attempts)


def quality_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """The tensor-health taps (pad tracer + sampled reductions) on the
    8-element fused device chain."""
    from nnstreamer_tpu_torch.obs import quality as obs_quality

    def disable():
        obs_quality.stop()
        obs_quality.reset()

    return three_state_report(_device_chain(acc), obs_quality.start, disable,
                              n_bufs, attempts)


def xfercheck_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """NNS_XFERCHECK's guard scopes and byte ledger on the 8-element fused
    device chain (its scope wraps the fused dispatch)."""
    from nnstreamer_tpu_torch.analysis import sanitizer as san

    def disable():
        san.disable_xfercheck()
        san.reset_xfercheck()

    return three_state_report(_device_chain(acc), san.enable_xfercheck,
                              disable, n_bufs, attempts)


def wire_roundtrip(n: int) -> float:
    """Seconds per round trip of one 16-float frame through the wire
    codec (``transport/frame.py``'s encode and decode)."""
    import numpy as np

    from nnstreamer_tpu_torch import transport
    from nnstreamer_tpu_torch.core import Buffer

    buf = Buffer([np.zeros((16,), np.float32)], meta={"tag": "bench"})
    settle()
    t0 = time.perf_counter()
    for _ in range(n):
        transport.decode_frame(bytes(transport.encode_frame_bytes(buf)))
    return (time.perf_counter() - t0) / n


def wirefuzz_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """NNS_WIREFUZZ's scorekeeper on the wire codec round trip, the one
    hot path it hooks (``transport/frame.py``, per encode and decode)."""
    from nnstreamer_tpu_torch.analysis import sanitizer as san

    return three_state_report(wire_roundtrip, san.enable_wirefuzz,
                              san.disable_wirefuzz, n_bufs, attempts)


def placement_overhead_report(n_bufs: int, acc: str, attempts: int = 3) -> dict:
    """A fused device chain through an applied PlacementPlan (the one
    segment pinned to the device, no store, no calibration) against the
    same chain with place off, pair by pair (gate 2%)."""
    import torch

    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.runtime.placement import Planner

    elem = device_elem(acc)
    probe = parse_launch(
        "tensor_src num-buffers=1 dimensions=16 types=float32 ! "
        + " ! ".join([elem] * 8) + " ! tensor_sink max-stored=1")
    dev = (torch.device("cpu") if acc == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    plan = Planner(devices=[dev]).plan(probe)
    measure(8, max(200, n_bufs // 4), elem)  # warm-up
    baselines, placeds = paired(
        lambda n: measure(8, n, elem),
        lambda n: measure(8, n, elem, place=plan), n_bufs, attempts)
    ratios = [p / b for b, p in zip(baselines, placeds)]
    return {
        "n_frames": n_bufs,
        "attempts": attempts,
        "rounds": ROUNDS,
        "baseline_us_per_frame": min(baselines) * 1e6,
        "placed_us_per_frame": min(placeds) * 1e6,
        "pair_ratios": [round(r, 4) for r in ratios],
        "placed_overhead_frac": min(ratios) - 1.0,
        "placed_overhead_frac_median": statistics.median(ratios) - 1.0,
    }


def stage_sweep_report(acc: str, n_bufs: int = 400) -> list:
    """Steady µs/frame of a 2-element fused device chain on host frames of
    each size (``n_bufs`` frames, fewer where they would pass 64 MiB),
    through the pinned stager and through the replay's own copy, timed in
    turn."""
    from nnstreamer_tpu_torch.runtime import fusion

    elem = device_elem(acc)
    keep = fusion.STAGE_MIN_BYTES
    out = []
    try:
        for nbytes in STAGE_SWEEP_BYTES:
            dims = str(max(1, nbytes // 4))
            n = max(20, min(n_bufs, (64 << 20) // nbytes))

            def path(cut):
                def run():
                    fusion.STAGE_MIN_BYTES = cut
                    return measure(2, n, elem, dims=dims, steady=True)
                return run

            measure(2, 20, elem, dims=dims)  # warm-up
            t = rounds({"stager": path(0), "direct": path(1 << 62)})
            out.append({"frame_bytes": nbytes, "frames": n,
                        "stager_us_per_frame": t["stager"] * 1e6,
                        "direct_us_per_frame": t["direct"] * 1e6})
    finally:
        fusion.STAGE_MIN_BYTES = keep
    return out


def trace_fused_report(acc: str, n_bufs: int = 500, top: int = 25) -> dict:
    """``torch.profiler`` over ``n_bufs`` dispatches of the 8-element fused
    device chain, host frames and device frames, each driven from this
    thread (the profiler sees only the thread that starts it): each
    call's count, host µs a frame (self time) and device µs a frame, the
    most costly on the host first, beside the dispatch's own µs a frame."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    elem = device_elem(acc)
    acts = [ProfilerActivity.CPU]
    if acc != "cpu":
        acts.append(ProfilerActivity.CUDA)
    dev = torch.device("cpu") if acc == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    with profile(activities=acts):
        pass   # the profiler's own lazy imports, before any pipeline runs
    out = {}
    for name, frame in (
            ("host_frames", lambda k: np.full(16, k, np.float32)),
            ("device_frames", lambda k: torch.full((16,), float(k),
                                                   device=dev))):
        pipe = parse_launch(
            "appsrc name=in caps=other/tensors,format=static,dimensions=16,"
            f"types=float32 ! {' ! '.join([elem] * 8)} ! tensor_sink "
            "max-stored=1")
        pipe.play()
        try:
            (seg,) = pipe.fused_segments
            # the first frame through appsrc negotiates the caps and
            # builds (and captures) the segment
            pipe.get("in").push_buffer(Buffer([frame(0)]))
            deadline = time.perf_counter() + 120
            while seg.stats["dispatches"] < 1:
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"trace: {seg} did not dispatch")
                time.sleep(0.01)
            pad = seg.head.sink_pads[0]
            for k in range(20):
                seg.dispatch(pad, Buffer([frame(k)]))
            bufs = [Buffer([frame(k)]) for k in range(n_bufs)]
            settle()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for b in bufs:
                    seg.dispatch(pad, b)
                wall = time.perf_counter() - t0
                settle()
        finally:
            pipe.stop()
        rows = sorted(prof.key_averages(),
                      key=lambda e: -e.self_cpu_time_total)
        out[name] = {
            "dispatch_us": wall / n_bufs * 1e6,
            "calls": [{"name": e.key, "count": e.count,
                       "self_host_us_per_frame":
                           e.self_cpu_time_total / n_bufs,
                       "device_us_per_frame": getattr(
                           e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / n_bufs}
                      for e in rows[:top]]}
    return out


STAGE_SWEEP_BYTES = (64, 1 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20,
                     4 << 20, 16 << 20)

# (report key, leg, chain it runs on, the smoke leg's frames); tracing
# first: its baseline needs a process where tracing was never enabled
LEGS = (
    ("tracing_overhead", tracing_overhead_report, "host chain", 2000),
    ("profiler_overhead", profiler_overhead_report, "host chain", 2000),
    ("placement_overhead", placement_overhead_report,
     "fused device chain", 1500),
    ("memory_overhead", memory_overhead_report, "fused device chain", 1500),
    ("quality_overhead", quality_overhead_report, "fused device chain", 1500),
    ("leakcheck_overhead", leakcheck_overhead_report, "host chain", 2000),
    ("xfercheck_overhead", xfercheck_overhead_report,
     "fused device chain", 1500),
    ("wirefuzz_overhead", wirefuzz_overhead_report, "wire round trip", 2000),
)


def gated_frac(key: str, leg: dict) -> float:
    return leg["placed_overhead_frac" if key == "placement_overhead"
               else "disabled_overhead_frac"]


def chain_runs(acc: str) -> dict:
    """The run of each chain a gate reads, by the name LEGS gives it."""
    return {"host chain": host_chain,
            "fused device chain": _device_chain(acc),
            "wire round trip": wire_roundtrip}


def verdicts(report: dict, speedup_gate: float) -> list:
    """(name, ok, line) for the speedup gate and every 2% gate."""
    out = []
    s = report["device_chain"]["speedup_marginal"]
    out.append(("fused_speedup", s >= speedup_gate,
                f"fused marginal speedup {s:.1f}x (gate >= "
                f"{speedup_gate:g}x)"))
    floors = report.get("noise_floor", {})
    for key, _, chain, _ in LEGS:
        leg = report[key]
        frac = gated_frac(key, leg)
        median = leg[("placed" if key == "placement_overhead"
                      else "disabled") + "_overhead_frac_median"]
        if key == "placement_overhead":
            state, tail = "placed", " vs place off (gate <= 2%)"
        else:
            state = "disabled"
            tail = (" vs baseline (gate <= 2%), enabled "
                    f"{leg['enabled_overhead_frac'] * 100:+.1f}%")
        floor = floors.get(chain)
        tail += (f"; median {median * 100:+.2f}%, noise floor of the "
                 f"{chain} " + (f"{floor['floor'] * 100:.2f}%"
                                if floor else "not measured"))
        out.append((key, frac <= GATE_FRAC,
                    f"{key.replace('_overhead', '')} ({chain}) {state} "
                    f"{frac * 100:+.2f}%{tail}"))
    return out


def main(argv=None) -> int:
    import torch

    from nnstreamer_tpu_torch.utils.hw_accel import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=DEFAULT_FRAMES)
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--json", dest="json_path", metavar="PATH",
                    help="write the full report as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="the gates: exit 1 when the 8-element device "
                    "chain's marginal speedup is below 2x on both attempts "
                    "or any disabled plane costs more than 2%%")
    ap.add_argument("--stage-sweep", action="store_true",
                    help="also time the stager against the replay's own "
                    "copy over frame sizes (reported, not gated)")
    ap.add_argument("--trace-fused", action="store_true",
                    help="also profile the 8-element fused chain's host "
                    "calls (reported, not gated)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    acc = "cpu" if dev.type == "cpu" else "gpu"

    def frames(n: int) -> int:
        if not args.smoke:
            return n
        return max(20, n * args.n_frames // DEFAULT_FRAMES)

    # the package, torch and CUDA state live to the end: out of the
    # collector's sight, so each settle() scans only the runs' garbage
    measure(1, 20, device_elem(acc))
    gc.freeze()
    report = {"device": acc,
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "smoke": args.smoke}
    attempts = SMOKE_ATTEMPTS if args.smoke else 3
    # the noise floor of each chain a gate reads, at its legs' frames
    report["noise_floor"] = {
        chain: noise_floor(run, frames(n) if args.smoke
                           else min(args.n_frames, 2000), attempts)
        for chain, run in chain_runs(acc).items()
        for n in [max(n for _, _, c, n in LEGS if c == chain)]}
    if args.smoke:
        for key, leg, _, n in LEGS[:2]:
            report[key] = leg(frames(n), acc, attempts=SMOKE_ATTEMPTS)
        best = None
        for _ in range(SMOKE_SPEEDUP_ATTEMPTS):   # a regression fails all
            dev_rep = device_chain_report(frames(1500), acc)
            if best is None or \
                    dev_rep["speedup_marginal"] > best["speedup_marginal"]:
                best = dev_rep
            if best["speedup_marginal"] >= SPEEDUP_SMOKE:
                break
        report["device_chain"] = best
        for key, leg, _, n in LEGS[2:]:
            report[key] = leg(frames(n), acc, attempts=SMOKE_ATTEMPTS)
        gate = SPEEDUP_SMOKE
    else:
        n = args.n_frames
        for key, leg, _, _ in LEGS:
            report[key] = leg(min(n, 2000), acc)
        report["host_chain"] = []
        prev = None
        for k in (1, 2, 4, 8, 16, 32):
            per_buf = measure(k, n)
            marginal = (per_buf - prev) / (k / 2) if prev is not None else None
            report["host_chain"].append(
                {"n": k, "us_per_frame": per_buf * 1e6,
                 "marginal_us_per_element":
                     marginal * 1e6 if marginal is not None else None})
            prev = per_buf
        report["device_chain"] = device_chain_report(n, acc)
        gate = SPEEDUP_FULL
    if args.stage_sweep:
        report["stage_sweep"] = stage_sweep_report(acc)
        for row in report["stage_sweep"]:
            print(f"stage sweep: {row['frame_bytes']} B frames, stager "
                  f"{row['stager_us_per_frame']:.2f} us, replay's copy "
                  f"{row['direct_us_per_frame']:.2f} us a frame")
    if args.trace_fused:
        report["trace_fused"] = trace_fused_report(acc)
        for name, tr in report["trace_fused"].items():
            print(f"trace fused ({name}): {tr['dispatch_us']:.2f} us a "
                  "dispatch; " + ", ".join(
                      f"{c['name']} x{c['count']} "
                      f"{c['self_host_us_per_frame']:.2f} us"
                      for c in tr["calls"][:8]))
    checks = verdicts(report, gate)
    report["gates"] = {name: ok for name, ok, _ in checks}
    print(json.dumps(report, indent=1))
    for name, ok, line in checks:
        print(f"{'smoke' if args.smoke else 'report'}: {line} "
              f"({'OK' if ok else 'REGRESSION'})")
    if args.json_path:
        with open(args.json_path, "w") as fh:
            json.dump(report, fh, indent=1)
    passed = all(ok for _, ok, _ in checks)
    print(f"gates on {report['device_name']}: "
          f"{'all passed' if passed else 'FAILED'}")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
