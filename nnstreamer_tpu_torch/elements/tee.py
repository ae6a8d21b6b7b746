"""Tee: 1-in/N-out stream duplication (GStreamer ``tee``).

This is the reference's *data-parallel* primitive — SURVEY.md §2.9: DP is
"tee + N parallel tensor_filter branches". Buffers are shared (not copied);
downstream elements must not mutate in place.
"""
from __future__ import annotations

from ..core import Buffer
from ..core.caps import any_media_caps
from ..registry.elements import register_element
from ..runtime.element import Element
from ..runtime.pad import Pad, PadDirection, PadPresence, PadTemplate

_ANY_MEDIA_CAPS = any_media_caps()


@register_element
class Tee(Element):
    ELEMENT_NAME = "tee"
    # fusion barrier (runtime/fusion.py): fan-out shares ONE buffer
    # across branches; a segment fusing through it could hand a sibling
    # branch a tensor the segment reuses
    FUSION_BARRIER = "tee fan-out (buffers shared across branches)"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _ANY_MEDIA_CAPS),)
    SRC_TEMPLATES = (
        PadTemplate("src_%u", PadDirection.SRC, _ANY_MEDIA_CAPS, PadPresence.REQUEST),
    )

    def chain(self, pad: Pad, buf: Buffer) -> None:
        for src in self.src_pads:
            src.push(buf)
