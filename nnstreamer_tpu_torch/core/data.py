"""Typed scalar values and arithmetic (L1).

Reference analog: ``gst/nnstreamer/tensor_data.c`` — a boxed typed scalar with
set/get/typecast/arithmetic, used by ``tensor_transform`` option parsing and
``tensor_if`` compared-value evaluation. Redesigned on numpy scalars: one
``TypedValue`` wraps a 0-d numpy array so all dtype promotion/clipping rules
come from numpy instead of the reference's per-dtype macro dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from .tensors import DataType

Number = Union[int, float]


@dataclass(frozen=True)
class TypedValue:
    value: np.generic

    @classmethod
    def of(cls, v: Number, dtype: "DataType | str | None" = None) -> "TypedValue":
        if dtype is None:
            dtype = DataType.INT64 if isinstance(v, int) else DataType.FLOAT64
        dt = DataType.from_any(dtype)
        return cls(dt.np_dtype.type(v))

    @property
    def dtype(self) -> DataType:
        return DataType.from_any(self.value.dtype)

    def typecast(self, dtype) -> "TypedValue":
        dt = DataType.from_any(dtype)
        return TypedValue(dt.np_dtype.type(self.value))

    def item(self) -> Number:
        return self.value.item()


def parse_number(text: str) -> Number:
    """Parse an option-string scalar ("1", "-2.5", "0x10")."""
    text = text.strip()
    try:
        if text.lower().startswith(("0x", "-0x")):
            return int(text, 16)
        return int(text)
    except ValueError:
        return float(text)
