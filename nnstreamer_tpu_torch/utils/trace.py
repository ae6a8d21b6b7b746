"""Pipeline tracers (L7 observability).

The port of nnstreamer_tpu's ``utils/trace.py``: the GstShark/NNShark
tracer ecosystem (proctime, interlatency, framerate, queue-level tracers
activated via ``GST_TRACERS``) as lightweight hooks in ``Pad.push`` —
zero-cost when disabled (one module-global check) — aggregating
per-element/per-pad metrics, plus a ``torch.profiler`` wrapper for
device-side traces.

Activation:
  * env: ``NNS_TRACERS="proctime;framerate;interlatency"`` (GST_TRACERS
    syntax) — installed automatically at the first ``Pipeline.play()``;
  * API: ``install_tracers(["proctime"])`` / ``uninstall_tracers()``;
  * results: ``trace_results()`` → {tracer: {key: metrics}};
  * graph dumps: ``NNS_DOT_DIR=/tmp`` writes ``<pipeline>.dot`` on play()
    (the reference's GST_DEBUG_DUMP_DOT_DIR).

Device-side: ``torch_trace(logdir)`` wraps ``torch.profiler.profile``
(CUDA activity when the card is in use) and writes a chrome trace into
``logdir``, so kernel timelines line up with host tracer spans.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

ACTIVE = False  # module-global fast path: Pad.push checks this only

_tracers: List["Tracer"] = []
_lock = threading.Lock()


class Tracer:
    NAME = ""

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        """Called after a pad push completed; elapsed covers the downstream
        element's chain work (inline dataflow)."""

    def serving_event(self, kind: str, name: str, start_s: float,
                      dur_s: float, meta: dict) -> None:
        """Called per serving-scheduler batch/step (serving/scheduler.py)
        so coalesced device batches show up next to element spans."""

    def results(self) -> dict:
        return {}


class ProcTimeTracer(Tracer):
    """Per-element processing time (GstShark proctime)."""

    NAME = "proctime"

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(lambda: [0, 0.0])

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        peer = pad.peer
        if peer is None:
            return
        cell = self._acc[peer.element.name]
        cell[0] += 1
        cell[1] += elapsed_s

    def results(self) -> dict:
        return {
            el: {"buffers": n, "total_s": t, "avg_ms": (t / n) * 1e3 if n else 0.0}
            for el, (n, t) in self._acc.items()
        }


class FramerateTracer(Tracer):
    """Per-pad frame rate (GstShark framerate)."""

    NAME = "framerate"

    def __init__(self):
        self._first: Dict[str, float] = {}
        self._last: Dict[str, float] = {}
        self._count: Dict[str, int] = defaultdict(int)

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        now = time.monotonic()
        key = pad.full_name
        self._first.setdefault(key, now)
        self._last[key] = now
        self._count[key] += 1

    def results(self) -> dict:
        out = {}
        for key, n in self._count.items():
            span = self._last[key] - self._first[key]
            out[key] = {"frames": n,
                        "fps": (n - 1) / span if span > 0 and n > 1 else 0.0}
        return out


class InterLatencyTracer(Tracer):
    """Source-to-pad latency (GstShark interlatency): each buffer is stamped
    at its first traced push; downstream pads record the delta."""

    NAME = "interlatency"
    _STAMP = "_trace_birth"

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        now = time.monotonic()
        birth = buf.meta.get(self._STAMP)
        if birth is None:
            buf.meta[self._STAMP] = now
            return
        cell = self._acc[pad.full_name]
        cell[0] += 1
        cell[1] += now - birth
        cell[2] = max(cell[2], now - birth)

    def results(self) -> dict:
        return {
            pad: {"buffers": n, "avg_ms": (t / n) * 1e3 if n else 0.0,
                  "max_ms": mx * 1e3}
            for pad, (n, t, mx) in self._acc.items()
        }


class QueueLevelTracer(Tracer):
    """Queue occupancy sampled at every flow through a queue's pads
    (GstShark queue-level)."""

    NAME = "queuelevel"

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(lambda: [0, 0, 0])

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        el = pad.element
        ch = getattr(el, "_ch", None)
        if ch is None and pad.peer is not None:
            el = pad.peer.element
            ch = getattr(el, "_ch", None)
        if ch is None:
            return
        level = getattr(ch, "_n_bufs", 0)
        cell = self._acc[el.name]
        cell[0] += 1
        cell[1] += level
        cell[2] = max(cell[2], level)

    def results(self) -> dict:
        return {
            el: {"samples": n, "avg_level": s / n if n else 0.0, "max_level": mx}
            for el, (n, s, mx) in self._acc.items()
        }


class ChromeTraceTracer(Tracer):
    """Complete-event trace viewable in chrome://tracing / Perfetto: one
    'X' span per element chain per buffer, thread-separated, lining up
    with ``torch_trace`` device traces. Path from NNS_CHROME_TRACE
    (explicit file), else ``<NNS_TRACE_DIR or system tmp>/
    nns_trace-<pid>.json`` — an ARTIFACT path, never the working
    directory: env-activated runs used to drop ``nns_trace.json`` into
    the repo checkout, where it churned every commit. Written by
    ``save()``, and — when env-activated — automatically at every
    ``Pipeline.stop()`` (:func:`flush_chrome_traces`) and at
    interpreter exit.

    Concurrency: a lock guards the event list's mutations, and
    ``save()``/``flush()`` SNAPSHOT the list under it before serializing
    — a flush racing in-flight ``buffer_flow`` calls can no longer
    interleave a half-written event list into the JSON dump, and the
    multi-second disk write of a large trace never blocks the streaming
    hot path (the per-event lock hold stays two list ops)."""

    NAME = "chrometrace"
    MAX_EVENTS = 1_000_000  # bound memory on endless streams

    def __init__(self, path: Optional[str] = None):
        self.path = (path or os.environ.get("NNS_CHROME_TRACE")
                     or default_chrome_trace_path())
        self._events: List[dict] = []
        self._t0 = time.perf_counter()
        self._saved = False
        self._elock = threading.Lock()  # guards _events + _saved vs writes
        self._env_activated = path is None
        if path is None:
            # env-activated use (NNS_TRACERS=chrometrace) has no code to
            # call save(); API users pass a path and save() themselves
            import atexit

            atexit.register(self.save)

    def buffer_flow(self, pad, buf, elapsed_s: float) -> None:
        peer = pad.peer
        if peer is None:
            return
        now = time.perf_counter()
        event = {
            "name": peer.element.name,
            "cat": "element",
            "ph": "X",
            "ts": (now - elapsed_s - self._t0) * 1e6,  # µs
            "dur": elapsed_s * 1e6,
            "pid": os.getpid(),
            # tids are arbitrary JSON numbers — never fold them (collisions
            # render as corrupt nesting in Perfetto)
            "tid": threading.get_ident(),
        }
        with self._elock:
            if self._saved or len(self._events) >= self.MAX_EVENTS:
                return
            self._events.append(event)

    def serving_event(self, kind: str, name: str, start_s: float,
                      dur_s: float, meta: dict) -> None:
        event = {
            "name": f"{kind}:{name}",
            # fused-segment spans (notify_fused) get their own
            # category so Perfetto separates one-dispatch chains from
            # serving batches
            "cat": "fused" if kind == "fused" else "serving",
            "ph": "X",
            # emitted immediately after the batch completes: now - dur
            # places the span on the same timeline as element spans
            "ts": (time.perf_counter() - self._t0 - dur_s) * 1e6,
            "dur": dur_s * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": meta,
        }
        with self._elock:
            if self._saved or len(self._events) >= self.MAX_EVENTS:
                return
            self._events.append(event)

    def _write(self, events: List[dict]) -> None:
        import json

        with open(self.path, "w") as fh:
            json.dump({"traceEvents": events}, fh)

    def flush(self) -> Optional[str]:
        """Write the events collected SO FAR without finalizing — the
        tracer keeps recording and a later flush/save rewrites the file
        with the fuller list (``Pipeline.stop()`` calls this for
        env-activated tracers). Returns the path written, or None when
        there was nothing to write. The disk write happens OUTSIDE the
        event lock (a snapshot is serialized), so concurrent pipelines
        keep streaming while a large trace writes."""
        with self._elock:
            if self._saved or not self._events:
                return None
            events = list(self._events)
        self._write(events)
        return self.path

    def save(self) -> Optional[str]:
        with self._elock:
            if self._saved or not self._events:
                return None
            # finalize FIRST (appends stop instantly, nothing can land
            # between snapshot and finalize and be lost), write outside
            # the lock; a failed write rolls the state back so a retry
            # can still flush the same events
            events, self._events = self._events, []
            self._saved = True
        try:
            self._write(events)
        except BaseException:
            with self._elock:
                self._saved = False
                self._events = events + self._events
            raise
        import atexit

        try:
            atexit.unregister(self.save)
        except Exception:  # noqa: BLE001 - unregister is best-effort
            pass
        return self.path

    def results(self) -> dict:
        with self._elock:
            return {"events": len(self._events), "path": self.path}


def default_chrome_trace_path() -> str:
    """The env-activated chrome-trace output path: per-pid file under
    ``NNS_TRACE_DIR`` (created on demand) or the system tmp dir. Per-pid
    so subprocess replicas sharing one env never clobber each other's
    trace; explicit ``NNS_CHROME_TRACE``/API paths always win."""
    import tempfile

    base = os.environ.get("NNS_TRACE_DIR", "").strip()
    if base:
        os.makedirs(base, exist_ok=True)
    else:
        base = tempfile.gettempdir()
    return os.path.join(base, f"nns_trace-{os.getpid()}.json")


_BUILTIN = {t.NAME: t for t in
            (ProcTimeTracer, FramerateTracer, InterLatencyTracer,
             QueueLevelTracer, ChromeTraceTracer)}


def install_tracers(names: List[str]) -> List[Tracer]:
    """Install tracers by name; returns the instances."""
    global ACTIVE
    instances = []
    with _lock:
        for n in names:
            n = n.strip()
            if not n:
                continue
            if n not in _BUILTIN:
                raise ValueError(f"unknown tracer '{n}' (have: {sorted(_BUILTIN)})")
            inst = _BUILTIN[n]()
            _tracers.append(inst)
            instances.append(inst)
        ACTIVE = bool(_tracers)
    return instances


def install_tracer(tracer: Tracer) -> None:
    """Install a custom Tracer instance."""
    global ACTIVE
    with _lock:
        _tracers.append(tracer)
        ACTIVE = True


def uninstall_tracer(tracer: Tracer) -> None:
    """Remove ONE installed tracer (the continuous profiler detaches
    itself without killing an app's chrometrace/proctime tracers)."""
    global ACTIVE
    with _lock:
        if tracer in _tracers:
            _tracers.remove(tracer)
        ACTIVE = bool(_tracers)


def uninstall_tracers() -> None:
    global ACTIVE
    with _lock:
        _tracers.clear()
        ACTIVE = False


def trace_results() -> dict:
    with _lock:
        return {t.NAME or type(t).__name__: t.results() for t in _tracers}


def flush_chrome_traces(env_only: bool = True) -> List[str]:
    """Flush installed ChromeTraceTracers to disk without finalizing
    them. Called from ``Pipeline.stop()`` for env-activated tracers
    (which otherwise only write at interpreter exit); pass
    ``env_only=False`` to also flush API-installed instances. Returns
    the paths written."""
    with _lock:
        tracers = [t for t in _tracers
                   if isinstance(t, ChromeTraceTracer)
                   and (t._env_activated or not env_only)]
    paths = []
    for t in tracers:
        try:
            p = t.flush()
        except OSError as e:
            from .log import logger

            logger.warning("chrometrace flush to %s failed: %s", t.path, e)
            continue
        if p:
            paths.append(p)
    return paths


_env_checked = False


def install_from_env() -> None:
    """Honor NNS_TRACERS once (called from Pipeline.play)."""
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    spec = os.environ.get("NNS_TRACERS", "")
    if spec:
        install_tracers(spec.replace(",", ";").split(";"))


def notify_flow(pad, buf, elapsed_s: float) -> None:
    """Hot-path fan-out (only reached when ACTIVE)."""
    for t in _tracers:
        try:
            t.buffer_flow(pad, buf, elapsed_s)
        except Exception:  # noqa: BLE001 - tracers must never kill dataflow
            pass


def notify_serving(kind: str, name: str, start_s: float, dur_s: float,
                   meta: dict) -> None:
    """Serving-scheduler fan-out (only called when ACTIVE): batch/step
    spans from serving/scheduler.py reach the same tracer set as pad
    flows."""
    for t in _tracers:
        try:
            t.serving_event(kind, name, start_s, dur_s, meta)
        except Exception:  # noqa: BLE001 - tracers must never kill serving
            pass


def notify_fused(name: str, start_s: float, dur_s: float, meta: dict) -> None:
    """Fused-segment span (only called when ACTIVE): one span per
    single-dispatch device chain, kind="fused", so traces show where N
    element hops collapsed into one call (``FusedSegment.dispatch``,
    runtime/fusion.py)."""
    notify_serving("fused", name, start_s, dur_s, meta)


def dump_dot(pipeline, reason: str = "play") -> Optional[str]:
    """Write <dot_dir>/<pipeline-name>.<reason>.dot when NNS_DOT_DIR is set
    (GST_DEBUG_DUMP_DOT_DIR analog). Returns the path written."""
    dot_dir = os.environ.get("NNS_DOT_DIR")
    if not dot_dir:
        return None
    os.makedirs(dot_dir, exist_ok=True)
    path = os.path.join(dot_dir, f"{pipeline.name}.{reason}.dot")
    with open(path, "w") as fh:
        fh.write(pipeline.to_dot())
    return path


@contextlib.contextmanager
def torch_trace(logdir: str, cuda: Optional[bool] = None):
    """Wrap a pipeline run in a ``torch.profiler`` trace and write it as
    ``<logdir>/torch_trace-<pid>-<n>.json`` (chrome-trace JSON, loadable
    in Perfetto beside the ``chrometrace`` tracer's element spans).
    ``cuda=None`` records CUDA activity when the card is in use (CUDA
    initialized in this process). Yields the profiler; its
    ``trace_path`` attribute names the file once the block has ended.
    Kernels launched through ``ctypes`` (the hand kernels of ``ops/``)
    appear under their CUDA names, like any other kernel.

    CUPTI can fail to deliver kernel records (on an H100 most long traces
    lose some and a few lose all, whatever the timing around start and
    stop), so the profiler's ``lost_kernel_records`` attribute counts
    the launches whose device record is missing (see
    :func:`lost_kernel_records`), and a warning names the file when it is
    not 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        global _torch_trace_n
        _torch_trace_n += 1
        path = os.path.join(
            logdir, f"torch_trace-{os.getpid()}-{_torch_trace_n}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
        prof.lost_kernel_records = lost_kernel_records(path) if cuda else 0
        if prof.lost_kernel_records:
            from .log import logger
            logger.warning(
                "torch_trace %s: CUPTI delivered no device record for %d "
                "kernel launches; their kernels are missing from the "
                "trace", path, prof.lost_kernel_records)


# runtime and driver API calls that launch kernels; each launch record
# shares its correlation id with the device records of what it launched
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                 "cuLaunchKernel", "cuLaunchKernelEx",
                 "cuLaunchCooperativeKernel", "cuGraphLaunch")


def lost_kernel_records(path: str) -> int:
    """Kernel launches in a chrome trace written by ``torch_trace`` whose
    device record is missing: launch records (``cuda_runtime`` or
    ``cuda_driver``) whose correlation id no ``kernel`` event carries.
    A graph launch counts as delivered when any one of its kernels is."""
    import json

    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    launched, delivered = set(), set()
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        cat = e.get("cat")
        if cat == "kernel":
            delivered.add(corr)
        elif (cat in ("cuda_runtime", "cuda_driver")
              and e.get("name") in _LAUNCH_CALLS):
            launched.add(corr)
    return len(launched - delivered)


_torch_trace_n = 0
