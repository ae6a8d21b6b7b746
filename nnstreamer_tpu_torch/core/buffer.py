"""Stream buffers (L1).

Reference analog: ``GstBuffer`` carrying one ``GstMemory`` chunk per tensor
plus pts/dts/duration and attachable metas (``gst_tensor_buffer_get_nth_memory``
/ ``append_memory``, gst/nnstreamer/nnstreamer_plugin_api_impl.c:1547-1790;
``GstMetaQuery`` client routing, gst/nnstreamer/tensor_meta.c).

A ``Buffer`` holds a list of arrays that live on the host (numpy arrays or
CPU ``torch.Tensor``s, both zero-copy) *or* on the device (CUDA
``torch.Tensor``s). Elements that chain device-resident tensors between
stages never bounce through host memory; ``as_numpy`` is the one explicit
device→host pull.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .tensors import TensorFormat, TensorsInfo

Array = Any  # np.ndarray | torch.Tensor


def _is_device_array(a) -> bool:
    return isinstance(a, torch.Tensor) and a.device.type != "cpu"


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _to_host(a):
    """Device tensor → numpy (bfloat16, which numpy lacks, stays a CPU
    tensor); host arrays and CPU tensors pass through uncopied."""
    if not _is_device_array(a):
        return a
    a = a.cpu()
    return a if a.dtype is torch.bfloat16 else a.numpy()


def is_host_bf16(a) -> bool:
    """A host bfloat16 tensor: numpy has no bfloat16, so the port keeps
    one as a CPU ``torch.bfloat16`` tensor and does its host work on it
    with torch ops."""
    return (isinstance(a, torch.Tensor) and a.dtype is torch.bfloat16
            and a.device.type == "cpu")


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor's bit patterns as a host uint16 array (one copy
    down for a card tensor) — the bytes nnstreamer_tpu's ``ml_dtypes``
    arrays hold."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def bf16_from_bits(a) -> torch.Tensor:
    """Host 2-byte bit patterns (a uint16 array or raw bytes viewed as
    one) as a CPU ``torch.bfloat16`` tensor of the same shape."""
    a = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(a.copy()).view(torch.bfloat16)


def as_torch(a) -> torch.Tensor:
    """A numpy array (zero-copy; a read-only one is copied, which
    ``torch.from_numpy`` needs) or a torch tensor as a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


@dataclass
class Buffer:
    """One frame of a tensor (or media) stream.

    ``tensors`` — the payload chunks. For ``other/tensors`` streams each entry
    is one tensor; for media streams there is a single entry (raw frame bytes
    viewed as an array).
    ``pts`` — presentation timestamp, seconds (float, monotonic clock domain).
    ``meta`` — attachable key/value metas (e.g. ``client_id`` for query
    routing — reference ``GstMetaQuery``).
    """

    tensors: list
    pts: Optional[float] = None
    duration: Optional[float] = None
    offset: Optional[int] = None  # frame sequence number
    meta: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in self.tensors)

    @property
    def on_device(self) -> bool:
        return any(_is_device_array(t) for t in self.tensors)

    def spec(self) -> TensorsInfo:
        """Per-frame specs (the FLEXIBLE format's per-memory header analog)."""
        return TensorsInfo.from_arrays(
            [t for t in self.tensors], TensorFormat.FLEXIBLE
        )

    # ------------------------------------------------------------------
    def as_numpy(self) -> "Buffer":
        """Materialize device tensors on host (``.cpu().numpy()``, which
        waits for the device). No copy for host arrays."""
        if not self.on_device:
            return self
        return replace(self, tensors=[_to_host(t) for t in self.tensors])

    def with_tensors(self, tensors: Sequence[Array]) -> "Buffer":
        return replace(self, tensors=list(tensors))

    def with_meta(self, **kv) -> "Buffer":
        return replace(self, meta={**self.meta, **kv})

    def copy_metadata_from(self, other: "Buffer") -> "Buffer":
        self.pts = other.pts
        self.duration = other.duration
        self.offset = other.offset
        self.meta = dict(other.meta)
        return self

    @classmethod
    def of(cls, *tensors: Array, pts: Optional[float] = None, **kw) -> "Buffer":
        return cls(list(tensors), pts=pts, **kw)

    def __repr__(self):
        shapes = ",".join(
            f"{t.dtype if isinstance(t, torch.Tensor) else np.asarray(t).dtype}"
            f"{tuple(t.shape)}"
            for t in self.tensors
        )
        loc = "dev" if self.on_device else "host"
        return f"Buffer<{shapes} {loc} pts={self.pts}>"


def clock_now() -> float:
    """Pipeline clock: monotonic seconds (GStreamer clock analog)."""
    return time.monotonic()
