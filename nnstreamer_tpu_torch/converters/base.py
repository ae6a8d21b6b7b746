"""Converter subplugin vtable (L2).

Reference analog: ``NNStreamerExternalConverter``
(gst/nnstreamer/include/nnstreamer_plugin_api_converter.h:41-85 —
``name/convert/get_out_config/query_caps``).
"""
from __future__ import annotations

from typing import Optional

from ..core import Buffer, Caps, TensorsInfo
from ..registry.subplugin import SubpluginKind, register


class Converter:
    NAME = ""

    def get_out_info(self, in_caps: Caps) -> TensorsInfo:
        """Output tensor spec for the given input caps (get_out_config)."""
        raise NotImplementedError

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError


def register_converter(cls):
    register(SubpluginKind.CONVERTER, cls.NAME, cls)
    return cls
