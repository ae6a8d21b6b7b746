"""fma_gemm's share of its roofline: the least time a forward's GEMM
work (every CONV_2D, the FULLY_CONNECTED and the MEAN, int8 bytes and
operations at the configuration's peak) could take, over the device
time of a forward's fma_gemm launches in the profiled slice, in
percent."""
from benchmark import flops
from benchmark.stats import kernel_forwards


def read(rec):
    if rec.profile is None:
        return None
    _, secs, fwd = kernel_forwards(rec, "fma_gemm")
    bound = flops.bound_s(rec.system.launches(rec.frames_per_buffer)["gemm"],
                          rec.system.peak)
    return 100 * bound / (secs / fwd)
