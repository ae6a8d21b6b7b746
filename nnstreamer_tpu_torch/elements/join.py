"""join: N→1 path combiner without sync (L3).

Reference analog: ``gst/join/gstjoin.c`` — forwards whichever input arrives
first; no merging, no synchronization (used after tensor_if/demux branches
that are mutually exclusive per frame).

The counterpart of nnstreamer_tpu's ``elements/join.py``.
"""
from __future__ import annotations

from ..core import Buffer, Caps, Event, EventType
from ..core.caps import any_media_caps
from ..registry.elements import register_element
from ..runtime.element import Element
from ..runtime.pad import Pad, PadDirection, PadPresence, PadTemplate


@register_element
class Join(Element):
    ELEMENT_NAME = "join"
    SINK_TEMPLATES = (
        PadTemplate("sink_%u", PadDirection.SINK, any_media_caps(),
                    PadPresence.REQUEST),
    )
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, any_media_caps()),)
    READONLY_PROPS = ("active-pad", "n-pads")

    def maybe_negotiate(self) -> None:
        # any single negotiated sink pad is enough (branches are exclusive);
        # first caps win (reference: active-pad switching)
        linked = [p for p in self.sink_pads if p.is_linked and p.caps is not None]
        if not linked or self.srcpad.caps is not None:
            return
        self.srcpad.push_event(Event.caps(linked[0].caps))

    # reference gstjoin.c read-only props: which sink pad forwarded last,
    # and how many sink pads exist
    def get_property(self, key: str):
        key_n = key.replace("-", "_")
        if key_n == "active_pad":
            return getattr(self, "_active_pad", "")
        if key_n == "n_pads":
            return len(self.sink_pads)
        return super().get_property(key)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        self._active_pad = pad.name
        self.push(buf)
