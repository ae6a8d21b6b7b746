"""The window's forward operations per second (frames labelled times
operations per frame) over the peak of the arithmetic the configuration
states, in percent."""


def read(rec):
    end = rec.t0 + rec.seconds
    fps = sum(1 for t in rec.label_times if rec.t0 <= t <= end) / rec.seconds
    return 100 * fps * rec.system.flops_per_frame / rec.system.peak
