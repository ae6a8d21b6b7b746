"""Frames whose label reached the sink inside the window, over the
window's seconds."""


def read(rec):
    end = rec.t0 + rec.seconds
    return sum(1 for t in rec.label_times if rec.t0 <= t <= end) / rec.seconds
