"""depthwise_fma's share of its roofline: the least time a forward's
DEPTHWISE_CONV_2D work could take (int8 bytes, operations at the
configuration's peak) over the device time of a forward's depthwise_fma
launches in the profiled slice, in percent."""
from benchmark import flops
from benchmark.stats import kernel_forwards


def read(rec):
    if rec.profile is None:
        return None
    _, secs, fwd = kernel_forwards(rec, "depthwise_fma")
    bound = flops.bound_s(rec.system.launches(rec.frames_per_buffer)["depthwise"],
                          rec.system.peak)
    return 100 * bound / (secs / fwd)
