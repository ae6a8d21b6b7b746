"""User-python decoder (``mode=python3``).

Reference analog: ``tensordec-python3.cc`` (393 LoC — embedded CPython user
decoder class), through nnstreamer_tpu's ``decoders/python_decoder.py``.
option1 = path to a .py file defining EITHER

* class ``Decoder`` with ``get_out_caps(in_info)`` / ``decode(buf, in_info)``
  (the framework's base.Decoder API), or
* class ``CustomDecoder`` with ``getOutCaps()`` / ``decode(raw_data,
  in_info, rate_n, rate_d)`` — the REFERENCE's user API
  (tensordec-python3.cc decode_: raw bytes per tensor, a list of
  ``nnstreamer_python.TensorShape`` in nnstreamer dim order, the frame
  rate; returns the encoded byte payload). Reference-written scripts run
  unmodified: ``import nnstreamer_python`` resolves to the port's shim
  (compat/nnstreamer_python.py).

A reference-style script gets each tensor's bytes from the host (a card
tensor is pulled once); a bfloat16 tensor's bytes are its bit patterns
and its shape's type is ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backends.python_backend import host_array, load_script
from ..core import Buffer, Caps, TensorsInfo, parse_caps_string
from ..core.buffer import bf16_bits
from .base import Decoder, register_decoder


class _ReferenceScriptDecoder:
    """Adapter: reference CustomDecoder → base.Decoder surface."""

    def __init__(self, inner):
        self._inner = inner

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        raw = self._inner.getOutCaps()
        if isinstance(raw, bytes):
            raw = raw.decode()
        return parse_caps_string(str(raw))

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        from ..compat.nnstreamer_python import TensorShape

        raw_data, shapes = [], []
        for t in buf.tensors:
            a = host_array(t)
            if isinstance(a, torch.Tensor):  # bfloat16
                raw, dtype = bf16_bits(a).tobytes(), torch.bfloat16
            else:
                a = np.ascontiguousarray(a)
                raw, dtype = a.tobytes(), a.dtype
            raw_data.append(raw)
            # nnstreamer dim order is fastest-axis-first — the reverse of
            # the numpy shapes this runtime carries
            shapes.append(TensorShape(list(reversed(tuple(a.shape))), dtype))
        rate_n, rate_d = buf.meta.get("framerate", (0, 1))
        payload = self._inner.decode(raw_data, shapes, int(rate_n), int(rate_d))
        if payload is None:
            return None
        return Buffer([np.frombuffer(bytes(payload), np.uint8)])


@register_decoder
class PythonDecoder(Decoder):
    MODE = "python3"

    def init(self, options):
        super().init(options)
        path = self.option(1)
        if not path:
            raise ValueError("python3 decoder: option1 must be a .py file")
        from ..compat import install_nnstreamer_python

        install_nnstreamer_python()
        ns = load_script(path)
        cls = ns.get("Decoder")
        if cls is not None:
            self._inner = cls()
            if hasattr(self._inner, "init"):
                self._inner.init(options[1:])
            return
        ref_cls = ns.get("CustomDecoder")
        if ref_cls is None:
            raise ValueError(
                f"{path}: must define class 'Decoder' (native API) or "
                "'CustomDecoder' (reference tensordec-python3 API)")
        self._inner = _ReferenceScriptDecoder(ref_cls())

    def get_out_caps(self, in_info: TensorsInfo) -> Optional[Caps]:
        return self._inner.get_out_caps(in_info)

    def decode(self, buf: Buffer, in_info: TensorsInfo) -> Optional[Buffer]:
        return self._inner.decode(buf, in_info)
