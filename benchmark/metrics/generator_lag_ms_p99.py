"""How late the open-loop generator offered buffers: 99th percentile of
push time minus due time, over the buffers due before the profiled
slice. Nothing to read in a closed loop."""
from benchmark.stats import nearest_rank


def read(rec):
    if rec.system.mix["loop"] != "open":
        return None
    v = nearest_rank([p - d for p, d in zip(rec.pushed, rec.due)
                      if rec.before_trace(d)], 0.99)
    return None if v is None else 1e3 * v
