"""TensorFlow-Lite filter backend (L4).

The counterpart of nnstreamer_tpu's ``backends/tflite_backend.py``.
Reference analog: ``ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc``
(1677 LoC — the reference's flagship backend: interpreter cache, delegate
selection, dynamic input resize). The interpreter runs on the host CPU
(device inference of a ``.tflite`` file is ``framework=torch``, through
``models/tflite_import.py``), so this backend exists for drop-in parity —
existing ``.tflite`` models run unchanged in the pipeline, and
``framework=auto`` picks it for ``*.tflite`` like the reference's
``framework_priority_tflite``. Card tensors cross to the host once,
explicitly; a bfloat16 input is refused (the interpreter has none).

TensorFlow is imported in :meth:`TFLiteBackend.open`, never at import: on
a host without it, opening raises :class:`~.base.FrameworkUnavailable`
naming tensorflow (a bus ERROR in a pipeline) — there is no quiet switch
to the importer.

Custom options (reference ``custom=`` string):
  ``num_threads:N`` — interpreter threads (reference NumThreads option).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import DataType, TensorsInfo
from ..core.tensors import TensorSpec
from ..utils.log import logger
from .base import (Accelerator, FilterBackend, FilterProperties,
                   import_tensorflow, register_backend)


def _details_to_info(details) -> Optional[TensorsInfo]:
    specs = []
    for d in details:
        shape = tuple(int(x) for x in d["shape"])
        if any(s < 0 for s in shape):
            return None  # dynamic dim: negotiate via set_input_info
        specs.append(TensorSpec(shape, DataType.from_any(d["dtype"])))
    return TensorsInfo.of(*specs)


def _host(x, framework: str = "tflite") -> np.ndarray:
    """A frame's tensor as a host array: a card tensor crosses once,
    explicitly. TensorFlow's runtimes take no bfloat16 from numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype is torch.bfloat16:
            raise TypeError(
                f"framework={framework}: bfloat16 input is not supported; "
                "cast it first (tensor_transform mode=typecast "
                "option=float32)")
        return x.detach().cpu().numpy()
    return np.asarray(x)


@register_backend
class TFLiteBackend(FilterBackend):
    NAME = "tflite"
    ALIASES = ("tensorflow-lite", "tensorflow2-lite", "tensorflow1-lite")
    ACCELERATORS = (Accelerator.CPU,)

    def __init__(self):
        super().__init__()
        self._interp = None
        self._in_details = None
        self._out_details = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        tf = import_tensorflow(self.NAME)

        opts = props.custom_dict()
        self._interp = tf.lite.Interpreter(
            model_path=props.model,
            num_threads=int(opts.get("num_threads", "0")) or None,
        )
        self._allocate()
        logger.info("tflite backend loaded %s", props.model)

    def _allocate(self) -> None:
        """(Re)allocate and cache the detail lists — they only change on
        resize, so the per-frame hot loop must not rebuild them."""
        self._interp.allocate_tensors()
        self._in_details = self._interp.get_input_details()
        self._out_details = self._interp.get_output_details()

    def close(self) -> None:
        self._interp = None
        self._in_details = self._out_details = None
        super().close()

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        return (
            _details_to_info(self._in_details),
            _details_to_info(self._out_details),
        )

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Resize interpreter inputs to the negotiated shapes (reference
        ``ResizeInputTensor`` path for dynamic models)."""
        details = self._in_details
        if len(details) != len(in_info.specs):
            raise ValueError(
                f"tflite model has {len(details)} inputs, caps declare "
                f"{len(in_info.specs)}"
            )
        for d, spec in zip(details, in_info.specs):
            if tuple(int(x) for x in d["shape"]) != tuple(spec.shape):
                self._interp.resize_tensor_input(d["index"], list(spec.shape))
        self._allocate()
        out = _details_to_info(self._out_details)
        if out is None:
            raise RuntimeError("tflite output shapes still dynamic after resize")
        return out

    def invoke(self, inputs: List[Any]) -> List[Any]:
        if self._interp is None:
            raise RuntimeError("tflite backend: invoke before open")
        details = self._in_details
        if len(inputs) != len(details):
            raise ValueError(
                f"tflite model takes {len(details)} inputs, got {len(inputs)}"
            )
        inputs = [_host(x) for x in inputs]
        resized = False
        for d, x in zip(details, inputs):
            arr = x
            if tuple(int(s) for s in d["shape"]) != arr.shape:
                self._interp.resize_tensor_input(d["index"], list(arr.shape))
                resized = True
        if resized:
            self._allocate()
            details = self._in_details
        for d, x in zip(details, inputs):
            arr = np.ascontiguousarray(x, dtype=d["dtype"])
            self._interp.set_tensor(d["index"], arr)
        self._interp.invoke()
        return [self._interp.get_tensor(d["index"]) for d in self._out_details]
