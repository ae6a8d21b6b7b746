"""Small statistics the metric readers share."""
from __future__ import annotations

import math
from typing import List, Optional


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share ``q`` of the values at or below it."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def latencies(rec, before_slice: bool = False) -> List[float]:
    """Seconds from each buffer's due time to the last of its labels, over
    every buffer due in the window (with ``before_slice``, those due
    before the profiled slice). A buffer never labelled counts as the
    longest wait the run allowed: the window and the drain after it."""
    from .core import DRAIN_S

    last = rec.t0 + rec.seconds + DRAIN_S
    return [rec.completed.get(s, last) - d for s, d in enumerate(rec.due)
            if not before_slice or rec.before_trace(d)]


def kernel_forwards(rec, needle: str) -> tuple:
    """(launches, device seconds, forwards) of the profiled kernels whose
    name holds ``needle``. The forwards are counted by the launches one
    forward makes; the count is held against the forwards the line was
    asked for while the profiler ran (the entries into the line's head on
    the host's clock), and a short count fails the run rather than being
    reported."""
    from .trace import kernel_totals

    per = rec.system.cfg["kernel_launches_per_forward"][needle]
    n, secs = kernel_totals(rec.profile, needle)
    a, b = rec.trace_window
    asked = sum(1 for t in rec.entry.values() if a <= t <= b)
    if n == 0 or abs(n / per - asked) > 2:
        raise RuntimeError(f"profile: {n} {needle} launches for {asked} forwards "
                           f"of {per} each: kernel records are missing")
    return n, secs, n / per
