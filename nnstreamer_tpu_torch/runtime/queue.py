"""Queue element: the thread boundary + backpressure primitive (L0').

Reference analog: GStreamer's ``queue`` element — the *only* source of
pipeline-stage parallelism in the reference (SURVEY.md §3.2: "parallelism
comes only from queue elements between filters"). A bounded buffer decouples
the upstream thread from a dedicated downstream worker; a full queue blocks
the producer (backpressure) or drops buffers when ``leaky``.

Only buffers count against ``max-size-buffers``; serialized events (CAPS/EOS)
are never dropped, never reordered, and never block.
"""
from __future__ import annotations

import threading
from collections import deque
from time import monotonic as _monotonic
from typing import Optional

from ..analysis import sanitizer as _san
from ..analysis.sanitizer import named_condition
from ..core import Buffer, Event, EventType
from ..core.caps import any_media_caps
from ..obs import profile as obs_profile
from .element import Element, Prop
from .pad import Pad, PadDirection, PadTemplate

_STOP = ("stop", None)


class _Channel:
    """Bounded MPSC channel: buffers obey capacity/leaky policy, events pass
    through in order unconditionally."""

    def __init__(self, capacity: int, leaky: str, name: str = "?"):
        self.capacity = capacity  # 0 (or less) = unbounded
        self.leaky = leaky
        # per-instance lock name: chained queues nest naturally (worker of
        # one pushes into the next) and must stay distinct graph nodes
        self._cond = named_condition(f"queue[{name}]._cond")
        self._dq: deque = deque()   # guarded-by: _cond
        self._closed = False        # guarded-by: _cond
        # buffers in _dq (events excluded), O(1) hot path
        self._n_bufs = 0            # guarded-by: _cond
        # leaky-mode loss accounting: upstream = incoming buffer refused,
        # downstream = oldest queued buffer evicted
        self.dropped_upstream = 0    # guarded-by: _cond
        self.dropped_downstream = 0  # guarded-by: _cond
        # depth retunes (set_capacity)
        self.retuned = 0             # guarded-by: _cond

    def reset_counters(self) -> None:
        with self._cond:
            self.dropped_upstream = 0
            self.dropped_downstream = 0

    def set_capacity(self, capacity: int) -> None:
        """Retune the depth while buffers flow. Capacity is only read
        under ``_cond``, and blocked producers are woken so a raised
        capacity (or a switch to unbounded) admits them at once."""
        capacity = max(0, int(capacity))
        with self._cond:
            if capacity == self.capacity:
                return
            self.capacity = capacity
            self.retuned += 1
            self._cond.notify_all()

    def put_buf(self, buf: Buffer) -> None:
        with self._cond:
            if self.capacity > 0 and self._n_bufs >= self.capacity:
                if self.leaky == "upstream":
                    self.dropped_upstream += 1
                    return  # drop the incoming (newest) buffer
                if self.leaky == "downstream":
                    for i, (kind, _) in enumerate(self._dq):
                        if kind == "buf":
                            del self._dq[i]  # drop the oldest buffer
                            self._n_bufs -= 1
                            self.dropped_downstream += 1
                            break
                else:
                    # capacity is re-read every slice: set_capacity may
                    # raise it or make the queue unbounded meanwhile
                    while (not self._closed and self.capacity > 0
                           and self._n_bufs >= self.capacity):
                        self._cond.wait(0.25)  # backpressure, bounded slice
                    if self._closed:
                        return
            self._dq.append(("buf", buf))
            self._n_bufs += 1
            self._cond.notify_all()

    def put_event(self, event: Event) -> None:
        with self._cond:
            self._dq.append(("event", event))
            self._cond.notify_all()

    def put_stop(self) -> None:
        with self._cond:
            self._closed = True
            self._dq.append(_STOP)
            self._cond.notify_all()

    def get(self):
        with self._cond:
            while not self._dq:
                # bounded slice: the stop sentinel normally wakes this,
                # but a worker must never be parked unwakeably forever
                self._cond.wait(0.25)
            item = self._dq.popleft()
            if item[0] == "buf":
                self._n_bufs -= 1
            self._cond.notify_all()
            return item

    def level(self) -> int:
        with self._cond:
            return self._n_bufs

    def clear(self) -> None:
        with self._cond:
            self._dq.clear()
            self._n_bufs = 0
            self._cond.notify_all()

    def reopen(self) -> None:
        with self._cond:
            self._closed = False


class QueueElement(Element):
    ELEMENT_NAME = "queue"
    # fusion barrier (runtime/fusion.py): the queue IS the thread +
    # backpressure boundary — fusing across it would delete the
    # pipeline-stage parallelism it exists to provide
    FUSION_BARRIER = "queue boundary (thread + backpressure decoupling)"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, any_media_caps()),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, any_media_caps()),)
    PROPERTIES = {
        "max_size_buffers": Prop(16, int, "queue capacity in buffers (0 = unbounded)"),
        "leaky": Prop("no", str, "no | upstream (drop new) | downstream (drop old)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._ch = _Channel(self.props["max_size_buffers"],
                            self.props["leaky"], name=self.name)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()

    @property
    def stats(self) -> dict:
        """Loss/occupancy counters (picked up by Pipeline.element_stats):
        leaky drops are counted, not silent."""
        ch = self._ch
        return {
            "level": ch.level(),
            "capacity": ch.capacity,
            "leaky": ch.leaky,
            "dropped_upstream": ch.dropped_upstream,
            "dropped_downstream": ch.dropped_downstream,
            "retuned": ch.retuned,
        }

    def set_capacity(self, capacity: int) -> None:
        """Resize the bounded channel without stopping flow (nnstreamer_tpu's
        placement planner tunes depths this way); counted in
        ``stats['retuned']``."""
        self._ch.set_capacity(capacity)

    def reset_flow(self) -> None:
        super().reset_flow()
        self._ch.reset_counters()

    # -- producer side ------------------------------------------------------
    def chain(self, pad: Pad, buf: Buffer) -> None:
        if obs_profile.ACTIVE:
            # queue-wait attribution: stamp entry, measured at the worker
            # pop (one module-global check when profiling is off; the
            # meta stamp races benignly on tee-shared buffers, same
            # contract as InterLatencyTracer's birth stamp)
            buf.meta["_prof_q_t0"] = _monotonic()
        self._ch.put_buf(buf)

    def handle_sink_event(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.CAPS:
            pad.caps = event.data["caps"]
            self._ch.put_event(event)
        elif event.type is EventType.EOS:
            pad.got_eos = True
            self._ch.put_event(event)
        elif event.type is EventType.FLUSH:
            self._ch.clear()
            self.forward_event(event)
        else:
            self._ch.put_event(event)

    # -- consumer side ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._ch.reopen()
        self._running.set()
        self._thread = threading.Thread(target=self._task, name=f"queue:{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        self._ch.put_stop()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None
        self._ch.clear()

    def _task(self) -> None:
        while self._running.is_set():
            kind, payload = self._ch.get()
            if kind == "stop":
                return
            if kind == "buf":
                # pop unconditionally: a stamp from a profiling session
                # that ended while the buffer was queued must not ride
                # the meta downstream (and onto the wire) forever
                t0 = payload.meta.pop("_prof_q_t0", None)
                if t0 is not None and obs_profile.ACTIVE:
                    obs_profile.record_queue_wait(
                        obs_profile.series_name(self),
                        _monotonic() - t0, self._ch._n_bufs)
                if _san.XFER:
                    # queue hand-off choke point: byte-accounting only —
                    # the worker thread may run host elements, so nothing
                    # is banned here. Device buffers cross by reference
                    # (zero copy), and the ledger proves it: "queue" rows
                    # carry bytes moved, not bytes copied.
                    _san.note_transfer(
                        f"queue:{self.name}",
                        "device" if payload.on_device else "host",
                        payload.nbytes)
                try:
                    self.srcpad.push(payload)
                except Exception as e:  # noqa: BLE001
                    self.post_error(f"{type(e).__name__}: {e}")
            elif payload.type is EventType.EOS:
                self.send_eos()
                return
            else:
                self.forward_event(payload)
