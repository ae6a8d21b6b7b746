"""User-python converter (``subplugin=python3``).

Reference analog: the python3 custom converter in
``ext/nnstreamer/tensor_converter/`` (embedded CPython user converter,
SURVEY.md §2.6), through nnstreamer_tpu's ``converters/python_converter.py``.
The ``tensor_converter`` element selects it via ``subplugin=python3
subplugin-option=<file.py>`` or the reference spelling
``mode=custom-script:<file.py>``; the file defines EITHER

* class ``Converter`` with ``get_out_info(in_caps)`` / ``convert(buf)``
  (the framework's base.Converter API), or
* class ``CustomConverter`` with ``convert(input_array)`` returning
  ``(tensors_info, raw_data, rate_n, rate_d)`` — the REFERENCE's user API
  (tensor_converter_python3: list of numpy arrays in, a list of
  ``nnstreamer_python.TensorShape`` + raw byte buffers out). Reference
  scripts run unmodified via the compat shim.

A reference-style script gets host arrays (a card tensor is pulled once;
bfloat16 arrives as a CPU ``torch.bfloat16`` tensor); a bfloat16 output
shape's raw bytes become a CPU ``torch.bfloat16`` tensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backends.python_backend import host_array, load_script
from ..core import Buffer, Caps, TensorFormat, TensorsInfo
from ..core.buffer import bf16_from_bits
from .base import Converter, register_converter


def raw_to_array(raw, dtype, dims):
    """One reference-API raw payload as an array of ``dtype`` shaped
    ``dims`` (numpy order); bfloat16 as a CPU torch tensor."""
    data = np.ascontiguousarray(np.asarray(raw)).tobytes()
    if dtype is torch.bfloat16:
        return bf16_from_bits(np.frombuffer(data, np.uint16)).reshape(dims)
    return np.frombuffer(data, np.dtype(dtype)).reshape(dims)


class _ReferenceScriptConverter:
    """Adapter: reference CustomConverter → base.Converter surface."""

    def __init__(self, inner):
        self._inner = inner

    def get_out_info(self, in_caps: Caps) -> TensorsInfo:
        return TensorsInfo((), TensorFormat.FLEXIBLE)  # shapes ride per frame

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        arrays_in = []
        for t in buf.tensors:
            a = host_array(t)
            arrays_in.append(a.contiguous() if isinstance(a, torch.Tensor)
                             else np.ascontiguousarray(a))
        result = self._inner.convert(arrays_in)
        if result is None:
            return None
        shapes, raw_data, rate_n, rate_d = result
        # nnstreamer dim order is fastest-axis-first → reverse for numpy
        arrays = [raw_to_array(raw, shape.getType(),
                               [int(d) for d in reversed(shape.getDims())])
                  for shape, raw in zip(shapes, raw_data)]
        out = Buffer(arrays)
        out.pts = buf.pts
        if (rate_n, rate_d) != (0, 0):
            out.meta["framerate"] = (int(rate_n), int(rate_d))
        return out


@register_converter
class PythonConverter(Converter):
    NAME = "python3"

    def __init__(self, option: Optional[str] = None):
        path = option
        if not path:
            raise ValueError("python3 converter: needs subplugin-option=<file.py>")
        from ..compat import install_nnstreamer_python

        install_nnstreamer_python()
        ns = load_script(path)
        cls = ns.get("Converter")
        if cls is not None:
            self._inner = cls()
            return
        ref_cls = ns.get("CustomConverter")
        if ref_cls is None:
            raise ValueError(
                f"{path}: must define class 'Converter' (native API) or "
                "'CustomConverter' (reference converter-python3 API)")
        self._inner = _ReferenceScriptConverter(ref_cls())

    def get_out_info(self, in_caps: Caps) -> TensorsInfo:
        return self._inner.get_out_info(in_caps)

    def convert(self, buf: Buffer) -> Optional[Buffer]:
        return self._inner.convert(buf)
