"""Custom-easy filter backend (``framework=custom-easy``).

Reference analog: ``tensor_filter_custom_easy``
(gst/nnstreamer/tensor_filter/tensor_filter_custom_easy.c:355 —
``NNS_custom_easy_register`` installs a single C function + in/out info under
a name, callable as ``framework=custom-easy model=<name>``), through
nnstreamer_tpu's ``backends/custom_easy.py``. Apps call
``register_custom_easy(name, fn, in_info, out_info)`` with a callable; the
registered entry is resolved by the ``model`` property.

The backend moves nothing: the callable gets the tensors as they arrive
(a card tensor stays on its card, a host one on the host) and its outputs
go downstream as it returns them. Like nnstreamer_tpu's, it hands out no
``fusion_callable``, so a custom-easy filter never joins a fused segment.
Without a registered ``out_info`` the output caps come from one call on
host zeros, as in nnstreamer_tpu; an entry whose callable wants card
tensors registers its ``out_info``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import TensorsInfo
from .base import (Accelerator, FilterBackend, FilterProperties,
                   check_accelerator, probe_output_info, register_backend)


@dataclass
class _CustomEntry:
    fn: Callable
    in_info: Optional[TensorsInfo]
    out_info: Optional[TensorsInfo]


_custom: Dict[str, _CustomEntry] = {}
_lock = threading.Lock()


def register_custom_easy(name: str, fn: Callable,
                         in_info: Optional[TensorsInfo] = None,
                         out_info: Optional[TensorsInfo] = None) -> None:
    """Install ``fn(inputs: list) -> list`` as ``framework=custom-easy
    model=<name>`` (reference ``NNS_custom_easy_register``)."""
    with _lock:
        _custom[name] = _CustomEntry(fn, in_info, out_info)


def unregister_custom_easy(name: str) -> bool:
    with _lock:
        return _custom.pop(name, None) is not None


@register_backend
class CustomEasyBackend(FilterBackend):
    NAME = "custom-easy"
    # NOTE: bare "custom" names the C-ABI .so backend (custom_c.py), matching
    # the reference's split between tensor_filter_custom and _custom_easy
    ALIASES = ("custom_easy",)
    ACCELERATORS = (Accelerator.CPU, Accelerator.GPU)

    def __init__(self):
        super().__init__()
        self._entry: Optional[_CustomEntry] = None

    def open(self, props: FilterProperties) -> None:
        check_accelerator(self, props)
        super().open(props)
        with _lock:
            entry = _custom.get(props.model)
        if entry is None:
            raise ValueError(
                f"no custom-easy filter '{props.model}' registered "
                f"(known: {sorted(_custom)})"
            )
        self._entry = entry

    def close(self) -> None:
        self._entry = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return self._entry.in_info, self._entry.out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        return probe_output_info(self, in_info)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        if self._entry is None:
            raise RuntimeError("custom-easy backend: invoke before open")
        out = self._entry.fn(inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]
