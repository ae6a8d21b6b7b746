"""Share of the profiled slice in which no kernel, copy or set ran on
the card, in percent."""


def read(rec):
    p = rec.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100 * (1 - p["busy_s"] / p["window_s"])
