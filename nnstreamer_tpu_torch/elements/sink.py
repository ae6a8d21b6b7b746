"""Sink elements.

Reference analogs: ``tensor_sink`` (terminal with ``new-data`` signal,
gst/nnstreamer/elements/gsttensor_sink.c) and GStreamer's ``appsink`` (pull
interface, used by the reference tests), ``fakesink``, and
``filesink``/``multifilesink`` (golden-file test outputs, SURVEY.md §4).
"""
from __future__ import annotations

import os
import queue as _queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core import Buffer
from ..core.caps import any_media_caps
from ..registry.elements import register_element
from ..runtime.element import Prop, SinkElement, prop_bool
from ..runtime.pad import PadDirection, PadTemplate

_ANY_MEDIA_CAPS = any_media_caps()


@register_element
class TensorSink(SinkElement):
    """Terminal tensor sink with new-data callbacks AND appsink-style pulls.

    Reference: ``tensor_sink`` emits a ``new-data`` GObject signal per buffer
    (gsttensor_sink.c); our callbacks play that role. ``pull()`` additionally
    gives the blocking-consume pattern the reference gets from ``appsink``.
    """

    ELEMENT_NAME = "tensor_sink"
    # accepts any media: plays both the reference's tensor_sink (tensors) and
    # appsink (text/video pulls in decoder tests) roles
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _ANY_MEDIA_CAPS),)
    PROPERTIES = {
        "sync": Prop(False, prop_bool, "honor buffer pts against the clock (unused yet)"),
        "max_stored": Prop(256, int, "keep last N buffers for pull() (0 = unbounded)"),
        # reference props: emit-signal gates callbacks entirely;
        # signal-rate > 0 emits at most that many callbacks per second
        # of buffer pts (frames in between are stored but not signalled)
        "emit_signal": Prop(True, prop_bool, "invoke new-data callbacks"),
        "signal_rate": Prop(0, int, "max callback emissions per second (0 = every buffer)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._callbacks: List[Callable[[Buffer], None]] = []
        self._q: _queue.Queue = _queue.Queue()
        self._count = 0
        self._lock = threading.Lock()

    def connect(self, callback: Callable[[Buffer], None]) -> None:
        """Register a new-data callback (``g_signal_connect`` analog)."""
        self._callbacks.append(callback)

    def reset_flow(self) -> None:
        super().reset_flow()
        # replayed pipelines restart pts at 0: a stale signal-rate epoch
        # would suppress every callback until pts passed the old run's
        if hasattr(self, "_last_signal_pts"):
            del self._last_signal_pts

    def render(self, buf: Buffer) -> None:
        with self._lock:
            self._count += 1
        emit = self.props["emit_signal"]
        rate = self.props["signal_rate"]
        if emit and rate > 0:
            # reference gst_tensor_sink_render: emit when at least 1/rate
            # of stream time passed since the last signalled buffer
            now = buf.pts
            last = getattr(self, "_last_signal_pts", None)
            if now is not None and last is not None and (now - last) < 1.0 / rate:
                emit = False
            elif now is not None:
                self._last_signal_pts = now
        if emit:
            for cb in self._callbacks:
                cb(buf)
        maxn = self.props["max_stored"]
        if maxn > 0:
            while self._q.qsize() >= maxn:
                try:
                    self._q.get_nowait()
                except _queue.Empty:
                    break
        self._q.put(buf)

    def pull(self, timeout: float = 5.0) -> Optional[Buffer]:
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    @property
    def buffer_count(self) -> int:
        with self._lock:
            return self._count


def _raw_bytes(t):
    """A host tensor's raw bytes as a buffer ``write()`` consumes without
    a per-tensor ``.tobytes()`` copy (bfloat16 through a uint8 view)."""
    if isinstance(t, torch.Tensor):
        # nnlint: disable=NNL101 — the sink's tensor is already on the host:
        # .numpy() is a view of its bytes
        return t.contiguous().view(torch.uint8).numpy().data
    return np.ascontiguousarray(t).data


@register_element
class FakeSink(SinkElement):
    """Discards everything (GStreamer ``fakesink``)."""

    ELEMENT_NAME = "fakesink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _ANY_MEDIA_CAPS),)

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.buffer_count = 0

    def render(self, buf: Buffer) -> None:
        self.buffer_count += 1


@register_element
class FileSink(SinkElement):
    """Appends every buffer's raw bytes to one file (``filesink``)."""

    ELEMENT_NAME = "filesink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _ANY_MEDIA_CAPS),)
    PROPERTIES = {
        "location": Prop(None, str, "output path"),
        # GStreamer basesink clock sync / buffering knobs; this runtime
        # renders as fast as upstream delivers and flushes per buffer, so
        # both are accepted as no-ops for reference launch-line compat
        "sync": Prop(False, prop_bool, "accepted for compat (no-op)"),
        "async": Prop(True, prop_bool, "accepted for compat (no-op)"),
        "buffer_mode": Prop("default", str, "accepted for compat (no-op)"),
    }

    def start(self) -> None:
        loc = self.props["location"]
        if not loc:
            raise ValueError(f"{self.describe()}: location not set")
        self._fh = open(loc, "wb")

    def stop(self) -> None:
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()
            self._fh = None

    def render(self, buf: Buffer) -> None:
        for t in buf.as_numpy().tensors:
            self._fh.write(_raw_bytes(t))
        self._fh.flush()


@register_element
class MultiFileSink(SinkElement):
    """Writes each buffer to ``location % index`` (``multifilesink``) — the
    reference's golden-file test pattern (SURVEY.md §4 SSAT tests)."""

    ELEMENT_NAME = "multifilesink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _ANY_MEDIA_CAPS),)
    PROPERTIES = {
        "location": Prop("out_%03d.raw", str, "printf-style path pattern"),
        # GStreamer basesink clock/preroll knobs; rendering here is
        # upstream-paced and per-buffer flushed, so these are no-ops
        "sync": Prop(False, prop_bool, "accepted for compat (no-op)"),
        "async": Prop(True, prop_bool, "accepted for compat (no-op)"),
        "buffer_mode": Prop("default", str, "accepted for compat (no-op)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._index = 0

    def render(self, buf: Buffer) -> None:
        path = self.props["location"] % self._index
        self._index += 1
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            for t in buf.as_numpy().tensors:
                fh.write(_raw_bytes(t))
