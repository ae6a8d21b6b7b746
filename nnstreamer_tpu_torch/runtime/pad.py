"""Pads: typed, linkable stream endpoints on elements (L0' substrate).

Reference analog: GstPad/GstPadTemplate — every reference element declares
static pad templates with caps (e.g. ``gst/nnstreamer/elements/gsttensor_converter.c``
sink/src templates) and data flows by ``gst_pad_push``. Our model keeps the
push semantics (caller's thread runs the downstream chain until a queue
boundary) and event-driven caps negotiation: a fixed CAPS event travels
downstream ahead of the first buffer.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from time import monotonic as _monotonic
from typing import TYPE_CHECKING, Optional

from ..core import Buffer, Caps, Event, EventType
from ..utils import trace

if TYPE_CHECKING:
    from .element import Element


class PadDirection(enum.Enum):
    SINK = "sink"
    SRC = "src"


class PadPresence(enum.Enum):
    ALWAYS = "always"
    REQUEST = "request"   # mux/demux-style on-demand pads ("sink_%u")


@dataclass(frozen=True)
class PadTemplate:
    name_template: str           # "sink", "src", "sink_%u", ...
    direction: PadDirection
    caps: Caps
    presence: PadPresence = PadPresence.ALWAYS

    @property
    def is_request(self) -> bool:
        return self.presence is PadPresence.REQUEST


class Pad:
    """One endpoint. Sink pads receive, src pads push."""

    def __init__(self, element: "Element", template: PadTemplate, name: str):
        self.element = element
        self.template = template
        self.name = name
        self.direction = template.direction
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None       # negotiated, fixed
        self.got_eos = False

    # ------------------------------------------------------------------
    @property
    def full_name(self) -> str:
        return f"{self.element.name}.{self.name}"

    @property
    def is_linked(self) -> bool:
        return self.peer is not None

    def link(self, other: "Pad") -> None:
        if self.direction is not PadDirection.SRC or other.direction is not PadDirection.SINK:
            raise ValueError(f"link must be src->sink ({self.full_name} -> {other.full_name})")
        if self.peer is not None or other.peer is not None:
            raise ValueError(f"pad already linked: {self.full_name} or {other.full_name}")
        if not self.template.caps.can_intersect(other.template.caps):
            raise ValueError(
                f"incompatible pad templates: {self.full_name} ({self.template.caps}) "
                f"!-> {other.full_name} ({other.template.caps})"
            )
        self.peer = other
        other.peer = self

    # ------------------------------------------------------------------
    # data flow (src side)
    def push(self, buf: Buffer) -> None:
        """Push a buffer downstream; runs the peer element's chain inline."""
        assert self.direction is PadDirection.SRC, f"push on sink pad {self.full_name}"
        peer = self.peer
        if peer is None:
            return  # unlinked src pad silently drops (reference: not-linked flow)
        if trace.ACTIVE:  # zero-cost when tracing is off (GstShark analog)
            t0 = _monotonic()
            peer.element._chain_guarded(peer, buf)
            trace.notify_flow(self, buf, _monotonic() - t0)
            return
        peer.element._chain_guarded(peer, buf)

    def push_event(self, event: Event) -> None:
        """Send an in-band event downstream (CAPS/EOS/SEGMENT/FLUSH)."""
        assert self.direction is PadDirection.SRC
        if event.type is EventType.CAPS:
            self.caps = event.data["caps"]
        peer = self.peer
        if peer is None:
            return
        peer.element._handle_sink_event_guarded(peer, event)

    # upstream events (sink side, e.g. QoS throttle)
    def send_upstream(self, event: Event) -> None:
        assert self.direction is PadDirection.SINK
        peer = self.peer
        if peer is None:
            return
        peer.element.handle_src_event(peer, event)

    def __repr__(self):
        return f"Pad<{self.full_name} {self.direction.value}>"
