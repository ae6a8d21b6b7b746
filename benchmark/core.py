"""The benchmark's harness: one cell, one seed, one run.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell in ``BENCHMARK.json``, its configuration
(``configs/<name>.json``), the system that configuration names
(``systems/<system>.py``: the line, the weights, the plain reference and
the comparison), its traffic mix (``traffic/<mix>.json``, read by
``traffic/generator.py``) and the readers of its metrics
(``metrics/<metric>.py``), each by name, so that a new cell, mix or
metric is new files and entries and no edit.

A run makes the frames and the weights on the card from the seed, builds
the cell's line with the program's ``parse_launch``, warms the shapes the
mix uses, offers the window's buffers through the line's ``appsrc`` and
collects the labels and the filter's outputs at two ``tensor_sink``s
behind a ``tee``. After the window it reads the peak memory, frees the
line, runs the plain reference over a sample of the window's buffers
drawn from the seed, compares, and prints one JSON line last on standard
output. With ``--trace 1`` the harness also times the calls into each
layer and records a slice of the window with ``torch.profiler``; the
line then carries the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import types
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .traffic import generator

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# what the printing process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "nnstreamer_tpu")
# the name under which a system registers the entry its line serves
ENTRY_MODULE = "perfbench_entries"
DRAIN_S = 60.0          # how long past the window a due buffer may arrive
WARMUP_TIMEOUT_S = 900.0


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that are
    FORBIDDEN, compared whole (``nnstreamer_tpu_torch`` is not
    ``nnstreamer_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"benchmark: no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(manifest: dict, name: str, bench: Path = BENCH) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics, read
    from the files their names give."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"benchmark: no workload {name!r} (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = json.loads((bench.parent / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, cfg, traffic, int(w["chips"]),
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)])


def load_system(name: str):
    """``systems/<name>.py``: how a configuration's line is built, served
    its weights, and checked."""
    return importlib.import_module(f"benchmark.systems.{name}")


def load_reader(metric: str, bench: Path = BENCH) -> Callable:
    return load_module(bench / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_")).read


# ---------------------------------------------------------------------------
# what a run records


@dataclass
class Record:
    """What the harness saw in one run; the metric readers read it. Times
    are the host's ``perf_counter`` seconds."""

    cell: str
    frames_per_buffer: int
    seconds: float
    setup_s: float = 0.0
    t0: float = 0.0
    due: List[float] = field(default_factory=list)       # absolute, per seq
    pushed: List[float] = field(default_factory=list)
    completed: Dict[int, float] = field(default_factory=dict)
    label_times: List[float] = field(default_factory=list)
    entry: Dict[int, float] = field(default_factory=dict)
    # name -> [(start, seconds)], of the window's buffers
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    stages: Dict[str, float] = field(default_factory=dict)   # host s: set-up, check
    counters: Dict[str, float] = field(default_factory=dict)
    profile: Optional[dict] = None
    trace_window: tuple = (0.0, 0.0)     # the profiled slice, host clock
    system: object = None

    def span(self, name: str, start: float, end: float) -> None:
        self.spans.setdefault(name, []).append((start, end - start))

    def before_trace(self, t: float) -> bool:
        """Whether host time ``t`` lies before the profiled slice: the
        host-side readers of a traced run read only that part, which the
        profiler does not slow."""
        return self.trace_window[0] == 0.0 or t < self.trace_window[0]

    def host_spans(self, name: str) -> List[float]:
        """Seconds of the spans ``name`` that started before the slice."""
        return [d for t, d in self.spans.get(name, []) if self.before_trace(t)]


class Collector:
    """The two sinks' callbacks: labels (decoder thread) and the filter's
    outputs (the raw branch's thread). Buffers carry their sequence number
    in ``offset``; warm-up buffers have negative numbers."""

    def __init__(self, rec: Record, sample_k: int, seed: int, on_done):
        self.rec = rec
        self.per = rec.frames_per_buffer
        self.labels: Dict[int, List[int]] = {}
        self.raw_count = 0
        self.sample_k = sample_k
        self.sample: Dict[int, torch.Tensor] = {}
        self.rng = np.random.default_rng([seed, 0x5A4D])
        self.on_done = on_done
        self.warm_done = threading.Event()
        self.warm_left = 0
        self.bad_offsets = 0
        self.lock = threading.Lock()

    def on_label(self, buf) -> None:
        now = time.perf_counter()
        seq = buf.offset
        idx = buf.meta.get("label_indices", [buf.meta.get("label_index")])
        with self.lock:
            if seq is None:
                self.bad_offsets += 1
                return
            got = self.labels.setdefault(seq, [])
            got.extend(int(i) for i in idx)
            full = len(got) >= self.per
            if seq >= 0:
                self.rec.label_times.extend([now] * len(idx))
                if full:
                    self.rec.completed[seq] = now
            elif full:
                self.warm_left -= 1
                if self.warm_left == 0:
                    self.warm_done.set()
        if full and seq >= 0:
            self.on_done(seq)

    def on_raw(self, buf) -> None:
        seq = buf.offset
        if seq is None or seq < 0:
            return
        with self.lock:
            # reservoir sampling over the window's outputs, in arrival order
            self.raw_count += 1
            n = self.raw_count
            if len(self.sample) < self.sample_k:
                self.sample[seq] = buf.tensors[0]
            else:
                j = int(self.rng.integers(0, n))
                if j < self.sample_k:
                    drop = sorted(self.sample)[j]
                    del self.sample[drop]
                    self.sample[seq] = buf.tensors[0]


# ---------------------------------------------------------------------------
# tracing: the harness's own spans around the calls into each layer


class Tracer:
    """Wraps element methods of a built line to time the calls into each
    layer, and holds ``torch.profiler`` over the window's last
    ``trace_seconds``. The profiler records the card's activity only:
    recording every host operation of the line's threads as well slowed
    an eager forward from about 6 to 10-14 ms a buffer and left a backlog
    for the rest of the window. Its idle gaps are named by the harness's
    own host spans instead (``trace.reduce``)."""

    def __init__(self, rec: Record, device: torch.device):
        self.rec = rec
        self.device = device
        self.prof = None
        self.window = (0.0, 0.0)
        self.start_s = 0.0          # perf_counter and the epoch's ns,
        self.start_epoch_ns = 0     # read together as the slice begins

    def attach(self, pipe) -> None:
        head, dec = pipe.get("head"), pipe.get("dec")
        rec = self.rec
        inner_head = head._chain_guarded

        def head_chain(pad, buf):
            seq = buf.offset
            t = time.perf_counter()
            if seq is not None and seq >= 0:
                rec.entry[seq] = t
            inner_head(pad, buf)
            if seq is not None and seq >= 0:
                rec.span("head", t, time.perf_counter())

        head._chain_guarded = head_chain
        inner_dec = dec.chain

        def dec_chain(pad, buf):
            t = time.perf_counter()
            inner_dec(pad, buf)
            if buf.offset is not None and buf.offset >= 0:
                rec.span("decoder", t, time.perf_counter())

        dec.chain = dec_chain

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA if self.device.type == "cuda"
                                   else ProfilerActivity.CPU])

    def warm(self) -> None:
        """Set-up: a first start of the profiler initialises its tracing
        library, which would otherwise eat into the slice."""
        prof = self._profiler()
        prof.start()
        prof.stop()

    def start(self) -> None:
        self.prof = self._profiler()
        self.prof.start()
        self.start_s = time.perf_counter()
        self.start_epoch_ns = time.time_ns()
        self.window = (self.start_s, 0.0)
        self.rec.trace_window = self.window

    def stop(self) -> None:
        if self.prof is None:
            return
        _sync(self.device)
        self.window = (self.window[0], time.perf_counter())
        self.prof.stop()
        self.rec.trace_window = self.window

    def finish(self) -> None:
        """After the drain: the profile, reduced."""
        if self.prof is not None:
            from . import trace

            self.rec.profile = trace.reduce(
                self.prof, self.window[1] - self.window[0], self.start_s,
                self.start_epoch_ns, self.rec.spans)


# ---------------------------------------------------------------------------
# one run


def _labels_file(classes: int) -> Path:
    path = ROOT / "build" / "perfbench" / f"labels_{classes}.txt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text("".join(f"class_{i:04d}\n" for i in range(classes)))
        os.replace(tmp, path)
    return path


def _program_counters(pipe) -> Dict[str, float]:
    """The fused segments' own counts: dispatches and their host seconds."""
    segs = pipe.fused_segments
    return {"segment_dispatches": sum(s.stats["dispatches"] for s in segs),
            "segment_total_s": sum(s.stats["total_s"] for s in segs)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             started: float, device, fault: Optional[Callable] = None,
             keep_frames: bool = False) -> dict:
    """One run of ``cell``. Returns the result's fields and, for tools and
    tests, the numbers compared (``checks``), the record and the sample.
    ``fault`` (tests only) is called with the built line before it plays."""
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    per = mix["frames_per_buffer"]
    rec = Record(cell.name, per, seconds)
    mark = [started]

    def stage(name: str) -> None:
        now = time.perf_counter()
        rec.stages[name] = now - mark[0]
        mark[0] = now

    stage("imports")
    pool = generator.make_pool(mix, seed, device)
    _sync(device)
    stage("frames")
    system = load_system(cfg["system"]).System(cfg, mix, seed, device, ROOT)
    rec.system = system
    system.prepare(pool)
    mod = sys.modules.setdefault(ENTRY_MODULE, types.ModuleType(ENTRY_MODULE))
    mod.entry = system.entry
    stage("weights")
    pipe = parse_launch(system.launch(_labels_file(system.num_classes), per))
    stage("parse")
    schedule = generator.make_schedule(mix, seed, seconds)
    src = pipe.get("src")

    def push(seq: int, idx: int) -> None:
        t = time.perf_counter()
        src.push_buffer(Buffer([pool[idx]], offset=seq))
        if trace:
            rec.span("push", t, time.perf_counter())

    driver = generator.Driver(schedule, push)
    coll = Collector(rec, mix["sample_buffers"], seed, driver.done)
    pipe.get("out").connect(coll.on_label)
    pipe.get("raw").connect(coll.on_raw)
    tracer = Tracer(rec, device)
    if trace:
        tracer.attach(pipe)
        tracer.warm()
    if fault is not None:
        fault(pipe)
    pipe.play()
    stage("play")
    try:
        # warm-up: every shape the window uses, labelled end to end
        n_warm = mix["warmup_buffers"]
        coll.warm_left = n_warm
        for k in range(n_warm):
            src.push_buffer(Buffer([pool[k % pool.shape[0]]], offset=-1 - k))
        if not coll.warm_done.wait(WARMUP_TIMEOUT_S):
            raise RuntimeError(f"warm-up: {coll.warm_left} of {n_warm} buffers "
                               "were not labelled")
        _sync(device)
        stage("warmup")
        before = _program_counters(pipe)
        rec.t0 = time.perf_counter()
        rec.setup_s = rec.t0 - started
        driver.start(rec.t0, seconds)
        end = rec.t0 + seconds
        if trace:
            # the window's last trace_seconds; the host-side readers read
            # what came before, with the line's counters as they stood
            _sleep_until(end - mix["trace_seconds"])
            host_counters = _program_counters(pipe)
            tracer.start()
            _sleep_until(tracer.start_s + mix["trace_seconds"])
            tracer.stop()
        _sleep_until(end)
        if not driver.finish(DRAIN_S):
            raise RuntimeError("the generator could not offer the window's "
                               f"buffers within {DRAIN_S} s of its end")
        rec.pushed = list(driver.pushed)
        n = len(rec.pushed)
        rec.due = ([rec.t0 + d for d in schedule.due] if schedule.loop == "open"
                   else list(rec.pushed))
        # every buffer due in the window is waited for, a minute at most
        limit = end + DRAIN_S
        while time.perf_counter() < limit:
            with coll.lock:
                if all(s in rec.completed for s in range(len(rec.due))) and \
                        coll.raw_count >= n:
                    break
            time.sleep(0.01)
        _sync(device)
        after = host_counters if trace else _program_counters(pipe)
        rec.counters = {k: after[k] - before.get(k, 0) for k in after}
        tracer.finish()
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else 0)
    finally:
        driver.abort()
        pipe.stop()
    labels = {s: v for s, v in coll.labels.items() if s >= 0}
    sample = dict(coll.sample)
    frames = {s: pool[schedule.pool_index[s]] for s in sample}
    del pipe, src, coll, pool
    system.release()
    mod.entry = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    attempted = len(rec.due)
    failed = attempted - sum(1 for s in range(attempted) if s in rec.completed
                             and len(labels.get(s, [])) == per)
    t = time.perf_counter()
    checks = system.check(sample, labels, frames)
    rec.stages["check"] = time.perf_counter() - t
    checks["undelivered"] = {"value": float(failed), "limit": 0.0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "memory_peak_bytes": int(memory_peak), "checks": checks,
           "record": rec}
    if keep_frames:
        out["sample"], out["frames"], out["labels"] = sample, frames, labels
    return out


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def read_metrics(cell: Cell, rec: Record, trace: bool) -> Dict[str, dict]:
    """Each metric of the cell for this kind of run, from its reader; a
    reader that finds nothing to read returns None and is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card_info(device: torch.device) -> Dict[str, str]:
    """The card's name and power limit, from nvidia-smi (read, never set)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return {"nvidia_smi": out}


# ---------------------------------------------------------------------------
# the command


def _parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def configure_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries that can pull in JAX from doing so."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv, started: float) -> int:
    args = _parse(argv)
    try:
        cell = find_cell(load_manifest(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    configure_caches()
    device = torch.device("cuda:0")
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), started, device)
    rec: Record = res["record"]
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad} after the window", file=sys.stderr)
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    result = {"correct": res["correct"], "attempted": res["attempted"],
              "failed": res["failed"],
              "metrics": read_metrics(cell, rec, bool(args.trace)),
              "device": dev}
    if args.trace:
        prof = rec.profile or {}
        dev["busy_s"] = prof.get("busy_s", 0.0)
        dev["window_s"] = prof.get("window_s", 0.0)
        if prof:
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    result["card"] = card_info(device)["nvidia_smi"]
    result["stages_s"] = rec.stages
    result["checks"] = res["checks"]
    if args.trace:
        print(f"trace: {prof.get('n_device_events')} device events; host spans "
              f"{'placed' if prof.get('spans_placed') else 'not placed'} on its clock",
              file=sys.stderr)
    print("stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in rec.stages.items()),
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
