"""tensor_sparse_enc / tensor_sparse_dec: static ↔ sparse stream conversion.

Reference analog: ``gsttensor_sparseenc.c``/``-dec.c``/``-util.c`` (SURVEY.md
§2.3) — COO-style {nnz, indices, values} packing behind the per-memory
``GstTensorMetaInfo.sparse_info`` header. Our sparse frame carries, per dense
tensor, two arrays (indices int32, values) plus the dense spec in
``buf.meta["sparse_specs"]``.

The counterpart of nnstreamer_tpu's ``elements/sparse.py`` (host COO
packing; a CUDA stream is pulled to the host once per buffer). Host
bfloat16, which numpy lacks, packs and unpacks with torch ops on the CPU;
its index tensor is int32 like every other dtype's.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import (
    Buffer,
    Caps,
    DataType,
    TensorFormat,
    TensorsInfo,
    caps_from_tensors_info,
    tensors_info_from_caps,
)
from ..core.buffer import as_torch, is_host_bf16
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, TransformElement
from ..runtime.pad import Pad, PadDirection, PadTemplate

_STATIC_CAPS = Caps.new("other/tensors", format="static")
_SPARSE_CAPS = Caps.new("other/tensors", format="sparse")


@register_element
class TensorSparseEnc(TransformElement):
    ELEMENT_NAME = "tensor_sparse_enc"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _STATIC_CAPS),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _SPARSE_CAPS),)
    DEVICE_AFFINITY = "host"  # COO packing runs on host arrays

    def transform_caps(self, src_pad: Pad) -> Caps:
        return caps_from_tensors_info(TensorsInfo((), TensorFormat.SPARSE))

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        tensors: List[np.ndarray] = []
        specs = []
        for t in buf.as_numpy().tensors:
            if is_host_bf16(t):
                # numpy has no bfloat16: the same COO packing in torch ops
                flat = t.reshape(-1)
                nz = torch.nonzero(flat).reshape(-1)
                # nnlint: disable=NNL101 — is_host_bf16(t): a host tensor,
                # .numpy() is a view, no device sync
                tensors.extend([nz.to(torch.int32).numpy(), flat[nz]])
                specs.append(TensorSpec(tuple(t.shape), t.dtype))
                continue
            a = np.asarray(t)
            flat = a.reshape(-1)
            idx = np.flatnonzero(flat).astype(np.int32)
            tensors.extend([idx, flat[idx]])
            specs.append(TensorSpec(a.shape, a.dtype))
        out = Buffer(tensors).copy_metadata_from(buf)
        out.meta["sparse_specs"] = specs
        return out


@register_element
class TensorSparseDec(TransformElement):
    ELEMENT_NAME = "tensor_sparse_dec"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _SPARSE_CAPS),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _STATIC_CAPS),)
    DEVICE_AFFINITY = "host"  # COO unpacking runs on host arrays

    def transform_caps(self, src_pad: Pad) -> Caps:
        # dense shape rides in per-buffer meta; stream stays flexible
        return caps_from_tensors_info(TensorsInfo((), TensorFormat.FLEXIBLE))

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        specs = buf.meta.get("sparse_specs")
        if specs is None:
            raise ElementError(f"{self.describe()}: sparse buffer without sparse_specs meta")
        out_tensors = []
        arrays = buf.as_numpy().tensors
        for i, spec in enumerate(specs):
            if spec.dtype is DataType.BFLOAT16:
                idx = torch.from_numpy(np.asarray(arrays[2 * i], np.int64))
                flat = torch.zeros(int(np.prod(spec.shape)),
                                   dtype=torch.bfloat16)
                flat[idx] = as_torch(arrays[2 * i + 1])
                out_tensors.append(flat.reshape(spec.shape))
                continue
            idx, vals = np.asarray(arrays[2 * i]), np.asarray(arrays[2 * i + 1])
            flat = np.zeros(int(np.prod(spec.shape)), dtype=spec.dtype.np_dtype)
            flat[idx] = vals
            out_tensors.append(flat.reshape(spec.shape))
        out = Buffer(out_tensors).copy_metadata_from(buf)
        out.meta.pop("sparse_specs", None)
        return out
