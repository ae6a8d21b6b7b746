"""In-band stream events and out-of-band bus messages (L0' substrate).

Reference analog: GStreamer events (EOS, CAPS, SEGMENT, QOS) and bus messages
(ERROR, ELEMENT, STATE_CHANGED) that the reference consumes from its L0, e.g.
QoS throttle events produced by ``tensor_rate``
(gst/nnstreamer/elements/gsttensor_rate.c:452-465) and handled by
``tensor_filter`` (tensor_filter/tensor_filter.c:512).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class EventType(enum.Enum):
    CAPS = "caps"          # downstream: negotiated caps follow
    SEGMENT = "segment"    # downstream: new stream segment
    EOS = "eos"            # downstream: end of stream
    FLUSH = "flush"        # both: drop queued data
    QOS = "qos"            # upstream: throttle/lateness feedback
    CUSTOM = "custom"


@dataclass
class Event:
    type: EventType
    data: dict = field(default_factory=dict)

    @classmethod
    def eos(cls) -> "Event":
        return cls(EventType.EOS)

    @classmethod
    def caps(cls, caps) -> "Event":
        return cls(EventType.CAPS, {"caps": caps})

    @classmethod
    def qos_throttle(cls, delay_s: float) -> "Event":
        """Reference: GST_QOS_TYPE_THROTTLE with timediff=delay."""
        return cls(EventType.QOS, {"throttle_delay_s": delay_s})

    def __repr__(self):
        return f"Event<{self.type.value} {self.data}>"


class MessageType(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    EOS = "eos"
    ELEMENT = "element"          # element-specific payload (trainer progress...)
    LATENCY = "latency"          # an element's latency estimate changed:
    # re-run Pipeline.query_latency() (reference gst_message_new_latency)
    STATE_CHANGED = "state-changed"


@dataclass
class Message:
    type: MessageType
    source: str              # element name
    data: dict = field(default_factory=dict)

    def __repr__(self):
        return f"Message<{self.type.value} from={self.source} {self.data}>"
