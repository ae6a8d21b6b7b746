"""User-python filter backend (``framework=python``, alias ``python3``).

Reference analog: ``ext/nnstreamer/tensor_filter/tensor_filter_python3.cc``
(embedded CPython running a user class with ``setInputDim``/``invoke``),
through nnstreamer_tpu's ``backends/python_backend.py``. The backend loads
a user class from a file or module and calls it with host arrays — no
tracing constraints (the escape hatch for non-traceable code, e.g.
OpenCV pre/post processing, mirroring custom_example_opencv).

The model file must define a class ``Filter`` (or a factory ``filter``) with:
  * ``invoke(self, inputs: list) -> list`` (required);
  * ``in_info``/``out_info`` attributes or ``set_input_info(in_info)``
    (optional, for negotiation; without them the output caps come from
    one invoke on host zeros, as in nnstreamer_tpu).

The script gets numpy arrays; a bfloat16 tensor, which numpy lacks,
arrives as a CPU ``torch.bfloat16`` tensor. A tensor on a card crosses to
the host once, through an explicit ``.cpu()`` (``host_pulls`` counts
them). The backend runs on the CPU only: ``accelerator=gpu`` is refused
at open.
"""
from __future__ import annotations

import importlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import TensorsInfo
from ..core.buffer import _is_device_array
from .base import (Accelerator, FilterBackend, FilterProperties,
                   check_accelerator, probe_output_info, register_backend)


def host_array(x):
    """``x`` as the host array a user script gets: numpy, or a CPU
    ``torch.bfloat16`` tensor; a card tensor is pulled once."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return x if x.dtype is torch.bfloat16 else x.numpy()
    return np.asarray(x)


def load_script(path: str) -> Dict[str, Any]:
    """Execute a user script file; its namespace."""
    ns: Dict[str, Any] = {"__file__": path}
    with open(path) as fh:
        exec(compile(fh.read(), path, "exec"), ns)  # noqa: S102 - user code
    return ns


@register_backend
class PythonBackend(FilterBackend):
    NAME = "python"
    ALIASES = ("python3",)
    ACCELERATORS = (Accelerator.CPU,)

    def __init__(self):
        super().__init__()
        self._obj = None
        # tensors pulled from a card for the script
        self.host_pulls = 0

    def open(self, props: FilterProperties) -> None:
        check_accelerator(self, props)
        super().open(props)
        model = props.model
        if model.endswith(".py") and os.path.exists(model):
            ns = load_script(model)
            factory = ns.get("Filter") or ns.get("filter")
        elif ":" in model:
            mod_name, _, attr = model.partition(":")
            factory = getattr(importlib.import_module(mod_name), attr)
        else:
            raise ValueError(f"python backend cannot load '{model}'")
        if factory is None:
            raise ValueError(f"{model}: must define class 'Filter' or callable 'filter'")
        self._obj = factory() if isinstance(factory, type) else factory
        if not hasattr(self._obj, "invoke"):
            # bare callable: wrap
            fn = self._obj

            class _Wrap:
                def invoke(self, inputs):
                    out = fn(*inputs)
                    return list(out) if isinstance(out, (list, tuple)) else [out]

            self._obj = _Wrap()

    def close(self) -> None:
        self._obj = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return (getattr(self._obj, "in_info", None), getattr(self._obj, "out_info", None))

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        if hasattr(self._obj, "set_input_info"):
            return self._obj.set_input_info(in_info)
        return probe_output_info(self, in_info)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        if self._obj is None:
            raise RuntimeError("python backend: invoke before open")
        self.host_pulls += sum(_is_device_array(x) for x in inputs)
        return self._obj.invoke([host_array(x) for x in inputs])
