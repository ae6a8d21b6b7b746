"""Median, over every buffer due in the window, of the time from its due
time at the generator to the last of its labels at the sink. A buffer
never labelled counts as the longest wait the run allowed."""
from benchmark.stats import latencies, nearest_rank


def read(rec):
    v = nearest_rank(latencies(rec), 0.5)
    return None if v is None else 1e3 * v
