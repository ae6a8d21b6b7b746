"""Host microseconds per dispatch of the line's fused segments in the
window before the profiled slice, from the segments' own counters
(dispatches, summed host time)."""


def read(rec):
    n = rec.counters.get("segment_dispatches", 0)
    return 1e6 * rec.counters["segment_total_s"] / n if n else None
