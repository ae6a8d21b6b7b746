"""Native custom-filter backend: user C/C++ shared objects via ctypes.

Reference analog: ``gst/nnstreamer/tensor_filter/tensor_filter_custom.c``
(338 LoC) — dlopen of a user ``.so`` implementing ``NNStreamer_custom_class``,
through nnstreamer_tpu's ``backends/custom_c.py``. The ABI is
``nnstreamer_tpu_torch/native/csrc/nns_custom_filter.h`` (plain C symbols,
no GLib; byte-identical to nnstreamer_tpu's, so one plugin loads in
either package): ``nns_custom_open/close/invoke`` plus ``get_info``
(static shapes) or ``set_input`` (dynamic). Outputs are caller-allocated
contiguous CPU torch tensors written in place through ``data_ptr()`` —
torch, so a bfloat16 output spec needs no numpy bfloat16.

Inputs cross to the host once: a card tensor through an explicit
``.cpu()``, a host array zero-copy. Outputs are host arrays (numpy;
bfloat16 stays a CPU torch tensor), as in nnstreamer_tpu. The backend
runs on the CPU only: ``accelerator=gpu`` is refused at open.

    tensor_filter framework=custom model=/path/libmyfilter.so custom=opts
"""
from __future__ import annotations

import ctypes
import os
from typing import Any, List, Optional, Tuple

import torch

from ..core import DataType, TensorsInfo
from ..core.buffer import as_torch
from ..core.tensors import TensorSpec
from ..utils.log import logger
from .base import (Accelerator, FilterBackend, FilterProperties,
                   check_accelerator, register_backend)

ABI_VERSION = 1
MAX_TENSORS = 16
MAX_RANK = 8
HEADER = "nnstreamer_tpu_torch/native/csrc/nns_custom_filter.h"

# order matches nns_dtype in nns_custom_filter.h == DataType declaration order
_DTYPES = list(DataType)


class _TensorSpecC(ctypes.Structure):
    _fields_ = [
        ("dtype", ctypes.c_int32),
        ("rank", ctypes.c_int32),
        ("dims", ctypes.c_int64 * MAX_RANK),
    ]


class _TensorsSpecC(ctypes.Structure):
    _fields_ = [
        ("num", ctypes.c_uint32),
        ("spec", _TensorSpecC * MAX_TENSORS),
    ]


class _TensorViewC(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("size", ctypes.c_uint64),
    ]


def _to_info(spec_c: _TensorsSpecC) -> TensorsInfo:
    specs = []
    for i in range(spec_c.num):
        s = spec_c.spec[i]
        if not 0 <= s.dtype < len(_DTYPES):
            raise ValueError(f"custom plugin declared unknown dtype code {s.dtype}")
        if not 0 <= s.rank <= MAX_RANK:
            raise ValueError(f"custom plugin declared invalid rank {s.rank}")
        specs.append(
            TensorSpec(tuple(int(d) for d in s.dims[: s.rank]), _DTYPES[s.dtype])
        )
    return TensorsInfo.of(*specs)


def _from_info(info: TensorsInfo) -> _TensorsSpecC:
    out = _TensorsSpecC()
    if len(info.specs) > MAX_TENSORS:
        raise ValueError(
            f"{len(info.specs)} tensors exceeds ABI max {MAX_TENSORS}"
        )
    out.num = len(info.specs)
    for i, s in enumerate(info.specs):
        if len(s.shape) > MAX_RANK:
            raise ValueError(f"rank {len(s.shape)} exceeds ABI max {MAX_RANK}")
        out.spec[i].dtype = _DTYPES.index(s.dtype)
        out.spec[i].rank = len(s.shape)
        for j, d in enumerate(s.shape):
            out.spec[i].dims[j] = int(d)
    return out


def _host_tensor(x) -> torch.Tensor:
    """A contiguous CPU tensor over ``x``: zero-copy for a host array, one
    explicit copy down for a card tensor."""
    t = as_torch(x)
    if t.device.type != "cpu":
        t = t.cpu()
    return t.contiguous()


def _views(tensors: List[torch.Tensor]):
    views = (_TensorViewC * len(tensors))()
    for i, t in enumerate(tensors):
        views[i].data = t.data_ptr()
        views[i].size = t.numel() * t.element_size()
    return views


@register_backend
class CustomCBackend(FilterBackend):
    NAME = "custom"
    ALIASES = ("custom-c", "cpp")
    ACCELERATORS = (Accelerator.CPU,)

    def __init__(self):
        super().__init__()
        self._lib: Optional[ctypes.CDLL] = None
        self._handle: Optional[ctypes.c_void_p] = None
        self._out_info: Optional[TensorsInfo] = None
        self._get_info = None
        self._set_input = None

    def _require_open(self) -> None:
        if self._lib is None or self._handle is None:
            raise RuntimeError("custom backend: not open")

    def open(self, props: FilterProperties) -> None:
        check_accelerator(self, props)
        super().open(props)
        if not os.path.exists(props.model):
            raise FileNotFoundError(f"custom filter .so not found: {props.model}")
        lib = ctypes.CDLL(props.model)

        missing = [
            sym for sym in
            ("nns_custom_abi_version", "nns_custom_open",
             "nns_custom_close", "nns_custom_invoke")
            if getattr(lib, sym, None) is None
        ]
        if missing:
            raise RuntimeError(
                f"{props.model} is not an nns custom-filter plugin "
                f"(missing symbols: {', '.join(missing)}); see {HEADER}"
            )
        lib.nns_custom_abi_version.restype = ctypes.c_int32
        version = lib.nns_custom_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(
                f"{props.model}: plugin ABI v{version}, loader expects "
                f"v{ABI_VERSION} ({HEADER})"
            )
        lib.nns_custom_open.restype = ctypes.c_void_p
        lib.nns_custom_open.argtypes = [ctypes.c_char_p]
        lib.nns_custom_close.argtypes = [ctypes.c_void_p]
        lib.nns_custom_invoke.restype = ctypes.c_int
        lib.nns_custom_invoke.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(_TensorViewC), ctypes.c_uint32,
            ctypes.POINTER(_TensorViewC), ctypes.c_uint32,
        ]
        self._get_info = getattr(lib, "nns_custom_get_info", None)
        if self._get_info is not None:
            self._get_info.restype = ctypes.c_int
            self._get_info.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(_TensorsSpecC), ctypes.POINTER(_TensorsSpecC),
            ]
        self._set_input = getattr(lib, "nns_custom_set_input", None)
        if self._set_input is not None:
            self._set_input.restype = ctypes.c_int
            self._set_input.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(_TensorsSpecC), ctypes.POINTER(_TensorsSpecC),
            ]
        if self._get_info is None and self._set_input is None:
            raise RuntimeError(
                f"{props.model}: plugin exports neither nns_custom_get_info "
                f"nor nns_custom_set_input ({HEADER})"
            )

        handle = lib.nns_custom_open((props.custom or "").encode())
        if not handle:
            raise RuntimeError(f"{props.model}: nns_custom_open failed")
        self._lib = lib
        self._handle = ctypes.c_void_p(handle)
        logger.info("custom backend loaded %s (abi v%d)", props.model, version)

    def close(self) -> None:
        if self._lib is not None and self._handle is not None:
            self._lib.nns_custom_close(self._handle)
        self._lib = None
        self._handle = None
        self._out_info = None
        self._get_info = None
        self._set_input = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        self._require_open()
        if self._get_info is None:
            return None, None
        in_c, out_c = _TensorsSpecC(), _TensorsSpecC()
        if self._get_info(self._handle, ctypes.byref(in_c), ctypes.byref(out_c)) != 0:
            return None, None
        in_info, out_info = _to_info(in_c), _to_info(out_c)
        self._out_info = out_info
        return in_info, out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        self._require_open()
        if self._set_input is None:
            _, out_info = self.get_model_info()
            if out_info is None:
                raise RuntimeError("custom plugin cannot negotiate shapes")
            return out_info
        in_c = _from_info(in_info)
        out_c = _TensorsSpecC()
        ret = self._set_input(self._handle, ctypes.byref(in_c), ctypes.byref(out_c))
        if ret != 0:
            raise RuntimeError(f"custom plugin rejected input spec (rc={ret})")
        self._out_info = _to_info(out_c)
        return self._out_info

    def invoke(self, inputs: List[Any]) -> List[Any]:
        self._require_open()
        ins = [_host_tensor(x) for x in inputs]
        if self._out_info is None:
            # negotiate from the live input shapes
            self.set_input_info(TensorsInfo.of(
                *(TensorSpec(tuple(t.shape), DataType.from_any(t.dtype))
                  for t in ins)))
        outs = [torch.empty(s.shape, dtype=s.dtype.torch_dtype)
                for s in self._out_info.specs]
        ret = self._lib.nns_custom_invoke(
            self._handle, _views(ins), len(ins), _views(outs), len(outs)
        )
        if ret != 0:
            raise RuntimeError(f"custom plugin invoke failed (rc={ret})")
        return [t if t.dtype is torch.bfloat16 else t.numpy() for t in outs]
