"""Reduction of a ``torch.profiler`` recording to the benchmark's numbers.

From the profiler's events (Kineto's, read directly; building
``FunctionEvent``s for some hundred thousand kernels would take minutes):

- every device activity (kernels, copies, sets) as an interval;
- ``busy_s``: the length of their union, on the first card;
- ``kernels``: launches and device seconds by name;
- ``device_ops``: the ten names that took the most device time;
- ``idle_gaps``: the ten longest gaps between device activities, each
  named by the harness's host span (``push``, ``head``, ``decoder``) that
  covered the gap's middle, or ``no span of the harness`` when none did.
  The profiler's clock is the Unix epoch's (on an H100, a kernel launched
  just after ``time.time_ns()`` was read started 0.41 ms after it): the host
  spans, on ``perf_counter``, are put on it by ``start`` and
  ``start_epoch_ns``, read together when the slice began. The mapping
  is kept only where the device's events then fall inside the slice.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(prof):
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    """A kernel, copy or set on a card."""
    if str(e.device_type()) != "DeviceType.CUDA":
        return False
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return False
    return not hasattr(e, "activity_type") or e.activity_type() in _DEVICE_KINDS


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def name_gaps(gaps: List[Tuple[int, int, int]], spans: List[Tuple[int, int, str]]
              ) -> List[list]:
    """Each (length, start, end) gap as [the span covering its middle,
    seconds]; of several, the one that started last."""
    spans = sorted(spans)
    out = []
    for g, a, b in gaps:
        t = (a + b) // 2
        inner = None
        for s0, s1, name in spans:
            if s0 > t:
                break
            if s1 >= t and (inner is None or s0 >= inner[0]):
                inner = (s0, name)
        out.append([inner[1] if inner else "no span of the harness", g * 1e-9])
    return out


def reduce(prof, window_s: float, start: float, start_epoch_ns: int,
           host: Dict[str, List[Tuple[float, float]]]) -> dict:
    dev: List[Tuple[int, int]] = []
    kernels: Dict[str, List[float]] = {}
    for e in _events(prof):
        if not _is_device(e):
            continue
        if e.device_index() not in (0, -1):
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        dev.append((a, b))
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += e.duration_ns() * 1e-9
    offset = None
    if dev:
        mid = sorted(a for a, _ in dev)[len(dev) // 2]
        if start_epoch_ns <= mid <= start_epoch_ns + int(window_s * 1e9):
            offset = start_epoch_ns - int(start * 1e9)
    merged = union(dev)
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    spans = []
    if offset is not None:
        for name, items in host.items():
            for t, d in items:
                a = int(t * 1e9) + offset
                spans.append((a, a + int(d * 1e9), name))
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda x: x[1], reverse=True)[:10]
    return {"busy_s": busy, "window_s": window_s, "device_ops": ops,
            "idle_gaps": name_gaps(gaps, spans), "kernels": kernels,
            "n_device_events": len(dev), "spans_placed": offset is not None}


def kernel_totals(profile: dict, needle: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``needle``."""
    n, s = 0, 0.0
    for name, (count, secs) in profile["kernels"].items():
        if needle in name:
            n += count
            s += secs
    return n, s
