"""Crash flight recorder: always-on bounded ring of recent events (L7).

The port of nnstreamer_tpu's ``obs/flight.py``, unchanged: pure Python.

The supervisor's postmortem question — "what was happening just before
this service stalled/crashed?" — needs history that was being recorded
BEFORE anyone knew to look. This ring records it continuously at
near-zero cost: one ``itertools.count`` tick (exact under the GIL, no
lock) plus one list-slot assignment per event; old events are simply
overwritten. It is never disabled.

What lands here (all low-rate control-plane signals, never per-buffer
dataflow): pipeline lifecycle transitions (playing/stopped/eos/error),
service state changes, supervisor crashes/restarts, fabric
evictions/readmissions/hedges/request errors, serving batch failures,
and — when request tracing is enabled — every finished span.

Consumers in this package: the serving plane records batch failures,
preemptions and memory sheds here; :func:`dump` reads them back. (The
supervisor's crash reports and the control plane's ``GET /flight`` come
with the service layer.)
"""
from __future__ import annotations

import itertools
import time
from typing import List, Optional


class FlightRecorder:
    """Lock-free bounded event ring.

    Writers race benignly: the sequence counter is exact (itertools under
    the GIL), each slot write is a single atomic list assignment of an
    immutable tuple, and a reader (:meth:`dump`) reconstructs order from
    the per-event sequence numbers — a torn iteration can only miss or
    double-see an event that was being overwritten anyway."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        self._slots: List[Optional[tuple]] = [None] * capacity
        self._seq = itertools.count()
        self._last = -1  # highest seq handed out (racy read is fine)

    def record(self, kind: str, name: str, data: Optional[dict] = None,
               pipeline: Optional[str] = None) -> None:
        i = next(self._seq)
        self._slots[i % self.capacity] = (
            i, time.time(), kind, name, data, pipeline)
        self._last = i

    def count(self) -> int:
        """Events recorded so far (>= retained)."""
        return self._last + 1

    def dump(self, last: Optional[int] = None,
             pipeline: Optional[str] = None,
             category: Optional[str] = None,
             after: Optional[int] = None) -> List[dict]:
        """The retained events, oldest first; ``last`` keeps only the
        newest N, ``pipeline`` filters on the event's pipeline tag, and
        ``category`` on the event kind (``memory``, ``slo``,
        ``pipeline``, ``serving``, ... — mirrors the pipeline filter, so
        a postmortem can pull one subsystem's channel). ``after`` keeps
        only events with ``seq > after`` — the tail-follow cursor
        (``obs flight --follow``, the fleet scraper's incremental
        pulls): a caller that remembers the last seq it saw gets each
        event exactly once, ring-overwrite permitting."""
        entries = sorted((s for s in list(self._slots) if s is not None),
                         key=lambda s: s[0])
        out = []
        for seq, t, kind, name, data, pipe in entries:
            if after is not None and seq <= after:
                continue
            if pipeline is not None and pipe != pipeline:
                continue
            if category is not None and kind != category:
                continue
            out.append({"seq": seq, "time": t, "kind": kind, "name": name,
                        "data": data, "pipeline": pipe})
        if last is not None:
            out = out[-last:]
        return out

    def clear(self) -> None:
        self._slots = [None] * self.capacity


# the process-wide recorder every subsystem publishes into
recorder = FlightRecorder()
record = recorder.record
dump = recorder.dump
count = recorder.count
