"""tensor_rate: framerate control + QoS load shedding (L3).

Reference analog: ``gst/nnstreamer/elements/gsttensor_rate.c`` (997 LoC) —
drops/duplicates frames to hit a target rate and, with ``throttle=true``,
sends ``GST_QOS_TYPE_THROTTLE`` events upstream so ``tensor_filter`` skips
invokes at the source (gsttensor_rate.c:452-465 → tensor_filter.c:512).

The counterpart of nnstreamer_tpu's ``elements/rate.py``; the port's
``tensor_filter`` honours the throttle event on both its paths.
"""
from __future__ import annotations

from typing import Optional

from ..core import Buffer, Caps, Event
from ..registry.elements import register_element
from ..runtime.element import Prop, TransformElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate


def _parse_rate(v) -> float:
    text = str(v)
    if "/" in text:
        num, den = text.split("/", 1)
        return int(num) / max(int(den), 1)
    return float(text)


@register_element
class TensorRate(TransformElement):
    ELEMENT_NAME = "tensor_rate"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    # read-only counters served by get_property (reference :957-978)
    READONLY_PROPS = ("in", "out", "drop", "duplicate")
    PROPERTIES = {
        "framerate": Prop(0.0, _parse_rate, "target output rate (fps or 'n/d'; 0 = off)"),
        "throttle": Prop(False, prop_bool, "send QoS throttle events upstream"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._next_slot = 0.0
        self.in_count = 0
        self.out_count = 0
        self.drop_count = 0
        self.dup_count = 0
        self._prev: Optional[Buffer] = None
        self._throttle_sent = False

    # reference read-only counters (gsttensor_rate.c:957-978)
    def get_property(self, key: str):
        stats = {"in": "in_count", "out": "out_count",
                 "drop": "drop_count", "duplicate": "dup_count"}
        attr = stats.get(key.replace("-", "_"))
        if attr is not None:
            return getattr(self, attr)
        return super().get_property(key)

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        rate = self.props["framerate"]
        if rate > 0 and self.props["throttle"] and not self._throttle_sent:
            # one-time steady-state throttle hint (reference re-sends per QoS
            # evaluation; a constant target rate needs only the steady value)
            pad.send_upstream(Event.qos_throttle(1.0 / rate))
            self._throttle_sent = True

    def reset_flow(self) -> None:
        super().reset_flow()
        self._next_slot = 0.0
        self._prev = None

    def chain(self, pad: Pad, buf: Buffer) -> None:
        self.in_count += 1
        rate = self.props["framerate"]
        if rate <= 0 or buf.pts is None:
            self.out_count += 1
            self.push(buf)
            return
        # emit at most one frame per 1/rate of stream time; the reference
        # keeps prevbuf current on EVERY input, so a later gap duplicates
        # the newest data even when that frame itself was rate-dropped
        if buf.pts + 1e-9 < self._next_slot:
            self.drop_count += 1
            self._prev = buf
            return
        # an input GAP past a whole slot re-emits the previous frame into
        # the missed slots (reference duplicate path, gsttensor_rate.c —
        # the output cadence stays constant under a slow upstream)
        if self._prev is not None:
            while buf.pts >= self._next_slot + 1.0 / rate - 1e-9:
                dup = self._prev.with_tensors(
                    list(self._prev.tensors)).copy_metadata_from(self._prev)
                dup.pts = self._next_slot
                self.dup_count += 1
                self.out_count += 1
                self.push(dup)
                self._next_slot += 1.0 / rate
        self._next_slot = max(self._next_slot, buf.pts) + 1.0 / rate
        self.out_count += 1
        self._prev = buf
        self.push(buf)
