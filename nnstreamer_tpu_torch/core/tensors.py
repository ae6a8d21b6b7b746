"""Tensor data model (L1).

Capability parity with the reference's tensor type system
(``gst/nnstreamer/include/tensor_typedef.h``: ``tensor_type`` enum :131,
``tensor_dim`` :141, ``tensor_format`` :151, ``GstTensorsInfo`` :230,
``GstTensorsConfig`` :254, ``GstTensorMetaInfo`` :280):

* shapes are plain python tuples in row-major ("C") order, matching numpy and
  torch, instead of the reference's fixed rank-16 column-major dims;
* ``bfloat16`` is a first-class dtype in addition to the reference's 11
  dtypes. numpy has no bfloat16, so it maps to ``torch.bfloat16`` only
  (``DataType.torch_dtype``); every other type keeps its numpy dtype for
  host-side conversion;
* specs are immutable dataclasses, usable as cache keys.

The reference's dimension *string* syntax ("3:224:224:1", lowest dim first) is
still parsed/emitted for launch-line compatibility.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

# Reference limits (tensor_typedef.h:30-44). We keep them as validation
# constants so launch-strings and wire headers stay bounded.
MAX_RANK = 16
MAX_TENSORS = 256


class DataType(enum.Enum):
    """Element dtype of one tensor (reference ``tensor_type``)."""

    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    UINT16 = "uint16"
    INT32 = "int32"
    UINT32 = "uint32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT16 = "float16"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BFLOAT16 = "bfloat16"  # addition to the reference's types
    BOOL = "bool"

    @property
    def np_dtype(self) -> np.dtype:
        if self is DataType.BFLOAT16:
            raise TypeError("numpy has no bfloat16; use DataType.torch_dtype")
        return np.dtype(self.value)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def itemsize(self) -> int:
        return self.torch_dtype.itemsize

    @property
    def is_float(self) -> bool:
        return self in (
            DataType.FLOAT16,
            DataType.FLOAT32,
            DataType.FLOAT64,
            DataType.BFLOAT16,
        )

    @classmethod
    def from_any(cls, value: "DataType | str | np.dtype | torch.dtype | type"
                 ) -> "DataType":
        if isinstance(value, DataType):
            return value
        if isinstance(value, torch.dtype):
            return cls(str(value).removeprefix("torch."))
        if isinstance(value, str):
            try:
                return cls(value)
            except ValueError:
                pass  # fall through to numpy name resolution
        # an extension-type bfloat16 numpy array resolves by its name
        return cls(np.dtype(value).name)


class TensorFormat(enum.Enum):
    """Stream data format (reference ``tensor_format`` tensor_typedef.h:151).

    STATIC   — every frame has the caps-negotiated shapes/dtypes.
    FLEXIBLE — per-frame shapes; each tensor carries its own spec (the
               reference serializes a ``GstTensorMetaInfo`` header per memory).
    SPARSE   — COO-compressed payloads.
    """

    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"


@dataclass(frozen=True)
class TensorSpec:
    """Shape+dtype+name of one tensor in a stream (reference ``GstTensorInfo``).

    ``shape`` may contain ``None`` entries only while un-fixated during caps
    negotiation; a fixated spec is fully static.
    """

    shape: tuple
    dtype: DataType = DataType.FLOAT32
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "dtype", DataType.from_any(self.dtype))
        if len(self.shape) > MAX_RANK:
            raise ValueError(f"rank {len(self.shape)} exceeds MAX_RANK={MAX_RANK}")
        for d in self.shape:
            if d is not None and (not isinstance(d, int) or d < 0):
                raise ValueError(f"bad dimension {d!r} in shape {self.shape!r}")

    # -- properties ---------------------------------------------------------
    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.shape:
            if d is None:
                raise ValueError(f"spec {self} is not fixated")
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.num_elements * self.dtype.itemsize

    @property
    def is_fixated(self) -> bool:
        return all(d is not None for d in self.shape)

    # -- converters ---------------------------------------------------------
    def with_name(self, name: str) -> "TensorSpec":
        return TensorSpec(self.shape, self.dtype, name)

    def to_dim_string(self) -> str:
        """Reference-style dim string: lowest (fastest-varying) dim first."""
        return ":".join(str(d) for d in reversed(self.shape))

    @classmethod
    def from_dim_string(cls, dims: str, dtype="float32", name="") -> "TensorSpec":
        """Parse "3:224:224:1" (reference order) into a row-major tuple shape.

        Reference impl: ``gst_tensor_parse_dimension``
        (gst/nnstreamer/nnstreamer_plugin_api_util_impl.c).
        """
        parts = [p for p in dims.strip().split(":") if p != ""]
        shape = tuple(int(p) for p in reversed(parts))
        return cls(shape, dtype, name)

    def matches(self, array) -> bool:
        """``array``: an ndarray or a torch.Tensor."""
        if DataType.from_any(array.dtype) is not self.dtype:
            return False
        if len(array.shape) != len(self.shape):
            return False
        return all(s is None or s == a for s, a in zip(self.shape, array.shape))

    def describe(self) -> str:
        shp = ",".join("?" if d is None else str(d) for d in self.shape)
        return f"{self.name or 'tensor'}:{self.dtype.value}[{shp}]"


@dataclass(frozen=True)
class TensorsInfo:
    """Spec of every tensor in one stream frame (reference ``GstTensorsInfo``
    tensor_typedef.h:230, plus the format field of ``GstTensorsConfig`` :254).

    For FLEXIBLE/SPARSE streams ``specs`` may be empty: shapes ride on each
    frame instead of the negotiated caps.
    """

    specs: tuple = ()
    format: TensorFormat = TensorFormat.STATIC

    def __post_init__(self):
        specs = tuple(self.specs)
        if len(specs) > MAX_TENSORS:
            raise ValueError(f"{len(specs)} tensors exceeds MAX_TENSORS={MAX_TENSORS}")
        object.__setattr__(self, "specs", specs)
        object.__setattr__(self, "format", TensorFormat(self.format))

    @property
    def num_tensors(self) -> int:
        return len(self.specs)

    @property
    def is_fixated(self) -> bool:
        if self.format is not TensorFormat.STATIC:
            return True
        return bool(self.specs) and all(s.is_fixated for s in self.specs)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.specs)

    def is_equal(self, other: "TensorsInfo") -> bool:
        """Reference ``gst_tensors_info_is_equal``: names are ignored."""
        if self.format is not other.format:
            return False
        if self.num_tensors != other.num_tensors:
            return False
        return all(
            a.shape == b.shape and a.dtype is b.dtype
            for a, b in zip(self.specs, other.specs)
        )

    @classmethod
    def of(cls, *specs: "TensorSpec | tuple", format=TensorFormat.STATIC) -> "TensorsInfo":
        out = []
        for s in specs:
            out.append(s if isinstance(s, TensorSpec) else TensorSpec(*s))
        return cls(tuple(out), format)

    @classmethod
    def from_arrays(cls, arrays: Sequence, format=TensorFormat.STATIC):
        return cls(
            tuple(TensorSpec(a.shape, DataType.from_any(a.dtype)) for a in arrays),
            format,
        )

    # -- launch-string / caps syntax ---------------------------------------
    def to_fields(self) -> dict:
        """Serialize to caps fields, reference caps-string style:
        ``num_tensors=2,dimensions=3:224:224:1.10:1,types=uint8.float32``."""
        fields: dict = {"format": self.format.value}
        if self.specs:
            fields["num_tensors"] = self.num_tensors
            fields["dimensions"] = ".".join(s.to_dim_string() for s in self.specs)
            fields["types"] = ".".join(s.dtype.value for s in self.specs)
            if any(s.name for s in self.specs):
                fields["names"] = ".".join(s.name for s in self.specs)
        return fields

    @classmethod
    def from_fields(cls, fields: dict) -> "TensorsInfo":
        fmt = TensorFormat(fields.get("format", "static"))
        dims = fields.get("dimensions")
        if dims is None:
            return cls((), fmt)
        types = str(fields.get("types", "")).split(".")
        names = str(fields.get("names", "")).split(".") if "names" in fields else []
        specs = []
        for i, d in enumerate(str(dims).split(".")):
            t = types[i] if i < len(types) and types[i] else "float32"
            n = names[i] if i < len(names) else ""
            specs.append(TensorSpec.from_dim_string(d, t, n))
        n_declared = fields.get("num_tensors")
        if n_declared is not None and int(n_declared) != len(specs):
            raise ValueError(
                f"num_tensors={n_declared} but {len(specs)} dimensions given"
            )
        return cls(tuple(specs), fmt)

    def describe(self) -> str:
        return f"{self.format.value}({', '.join(s.describe() for s in self.specs)})"


def validate_arrays(info: TensorsInfo, arrays: Sequence) -> None:
    """Raise if ``arrays`` does not satisfy ``info`` (static format only)."""
    if info.format is not TensorFormat.STATIC:
        return
    if len(arrays) != info.num_tensors:
        raise ValueError(
            f"frame has {len(arrays)} tensors, caps declare {info.num_tensors}"
        )
    for spec, arr in zip(info.specs, arrays):
        if not spec.matches(arr):
            raise ValueError(
                f"tensor {arr.dtype}{arr.shape} does not match spec {spec.describe()}"
            )
