"""Median host milliseconds of the decoder's chain per buffer (the
argmax on the card and the pull of the labels included), over the
window's buffers before the profiled slice."""
import statistics


def read(rec):
    spans = rec.host_spans("decoder")
    return 1e3 * statistics.median(spans) if spans else None
