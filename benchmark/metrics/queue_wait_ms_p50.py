"""Median time from a buffer's due time to its entry into the line's
first device element (appsrc's queue and the pipeline before it), over
the buffers that entered before the profiled slice."""
import statistics


def read(rec):
    waits = [t - rec.due[s] for s, t in rec.entry.items()
             if s < len(rec.due) and rec.before_trace(t)]
    return 1e3 * statistics.median(waits) if waits else None
