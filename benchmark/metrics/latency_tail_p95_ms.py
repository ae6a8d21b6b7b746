"""95th percentile of the time from a buffer's due time at the generator
to the last of its labels at the sink, over every buffer due before the
profiled slice (all of the window in an untraced run). A buffer never
labelled counts as the longest wait the run allowed. The tail of the
latency whose median is ``latency_p50_ms``: it is made by the queueing
behind buffers that a slow moment of the host held up."""
from benchmark.stats import latencies, nearest_rank


def read(rec):
    v = nearest_rank(latencies(rec, before_slice=True), 0.95)
    return None if v is None else 1e3 * v
