"""The forwards' operations in the profiled slice over the compute
dtype's peak times the card's busy time there, in percent: the forwards
are the buffers that entered the line's head in the slice."""


def read(rec):
    p = rec.profile
    if p is None or p["busy_s"] <= 0:
        return None
    a, b = rec.trace_window
    n = sum(1 for t in rec.entry.values() if a <= t <= b)
    ops = rec.system.flops_per_frame * rec.frames_per_buffer * n
    return 100 * ops / (rec.system.peak * p["busy_s"])
