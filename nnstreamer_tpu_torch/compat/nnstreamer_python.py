"""``nnstreamer_python`` drop-in: the helper module reference user scripts
import (ext/nnstreamer/extra/nnstreamer_python3_helper.cc TensorShape —
init(dims, type), getDims, getType, setDims, setType).

Scripts use it as::

    import nnstreamer_python as nns
    shape = nns.TensorShape([3, 224, 224, 1], np.float32)
    shape.getDims()          # -> [3, 224, 224, 1]
    shape.getType().type     # -> numpy scalar type (getType returns np.dtype)

A bfloat16 shape is the one difference from nnstreamer_tpu's shim: numpy
has no bfloat16 (nnstreamer_tpu takes it from ``ml_dtypes``, which a CUDA
deployment need not have), so ``getType()`` of a bfloat16 shape returns
``torch.bfloat16``, and ``setType`` accepts it or the name ``"bfloat16"``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch


def _dtype(type) -> Union[np.dtype, torch.dtype]:
    if type is torch.bfloat16 or (isinstance(type, str)
                                  and type == "bfloat16"):
        return torch.bfloat16
    dt = np.dtype(type)
    # an extension bfloat16 (ml_dtypes, where installed) maps to torch's
    return torch.bfloat16 if dt.name == "bfloat16" else dt


class TensorShape:
    """Reference TensorShape: a (dims, dtype) pair."""

    def __init__(self, dims: Optional[Sequence[int]] = None, type=np.uint8):
        self._dims: List[int] = []
        self._type = _dtype(type)
        if dims is not None:
            self.setDims(dims)

    def setDims(self, dims: Sequence[int]) -> None:
        # reference caps dims at NNS_TENSOR_RANK_LIMIT and int-casts
        self._dims = [int(d) for d in dims][:16]

    def getDims(self) -> List[int]:
        return self._dims

    def setType(self, type) -> None:
        self._type = _dtype(type)

    def getType(self) -> Union[np.dtype, torch.dtype]:
        return self._type

    def __repr__(self) -> str:  # debugging nicety, not reference API
        return f"TensorShape({self._dims}, {self._type})"
