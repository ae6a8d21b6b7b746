"""Double-buffered host→device staging (L5 → runtime).

nnstreamer_tpu's ``transport/staging.py`` issues an async
``jax.device_put`` per frame and parks the handles in a two-slot
rotation, so that frame N+1's transfer overlaps frame N's device compute.
A CUDA copy from pageable host memory cannot be asynchronous, so here the
two slots are **pinned host buffers**: ``stage()`` copies a host frame
into its slot, issues the host→device copy on a side stream, records a
CUDA event, and makes the caller's stream wait on that event — on the
card, not on the host. The caller then launches frame N+1's work behind
frame N's, and the copy runs while frame N computes. A slot is rewritten
two frames later, after its previous copy's event has completed.

Each staged device tensor is allocated on the side stream and handed to
the caller's stream (``record_stream``), so the caching allocator never
reuses its block while either stream may still touch it; the tensors
stay valid for as long as the caller holds them.

Used by the fused dispatch of every segment on a card that receives
host inputs (``runtime/fusion.py``); measured against a plain blocking
copy in ``chip_smoke.py`` phase 13d. A stager made with ``min_bytes``
hands a frame whose host tensors hold fewer bytes back on the host
(``direct`` counts them): its consumer copies it where it needs it
(the fused replay into its graph's static input), since for a small
frame the side stream, the event and the pinned slot cost more than the
copy they would overlap. On a CPU target (the tests) ``stage`` is a plain
conversion. Device tensors pass through untouched.
"""
from __future__ import annotations

import sys as _sys
import threading
from typing import Any, List, Optional, Sequence

import torch

from ..core.buffer import as_torch


def _note_h2d(nbytes: int) -> None:
    _san = _sys.modules.get("nnstreamer_tpu_torch.analysis.sanitizer")
    if _san is not None and _san.XFER:
        _san.note_transfer("staging:put", "h2d", nbytes)


class _Slot:
    """One pinned host slot: a pinned buffer per tensor position and the
    event of the last copy out of it."""

    __slots__ = ("pinned", "done")

    def __init__(self):
        self.pinned: List[Optional[torch.Tensor]] = []
        self.done: Optional[torch.cuda.Event] = None


class DoubleBufferedStager:
    """Two-slot host→device staging pipeline for one dispatch site.

    ``stage(tensors)`` returns every input on the stager's device: host
    inputs through a pinned slot and an async copy on the side stream,
    device inputs untouched. Thread-safe: the owning dispatch site may be
    driven from several pipeline threads."""

    def __init__(self, device: Optional[Any] = None, depth: int = 2,
                 min_bytes: int = 0):
        if depth < 2:
            raise ValueError("staging needs at least two slots to overlap")
        self._device = torch.device(device) if device is not None else None
        self._depth = depth
        self.min_bytes = min_bytes
        self._lock = threading.Lock()
        self._slots: List[_Slot] = [_Slot() for _ in range(depth)]
        self._turn = 0
        self._side: Optional[torch.cuda.Stream] = None
        self.puts = 0        # guarded-by: _lock
        self.put_bytes = 0   # guarded-by: _lock
        self.direct = 0      # guarded-by: _lock

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    def retarget(self, device: Optional[Any]) -> None:
        """Follow a placement re-plan: drop the slots and the side stream
        (they belong to the old card) and stage onto ``device`` from now
        on."""
        with self._lock:
            self._device = torch.device(device) if device is not None else None
            self._slots = [_Slot() for _ in range(self._depth)]
            self._turn = 0
            self._side = None

    def _is_cuda(self) -> bool:
        return self._device is not None and self._device.type == "cuda"

    def stage(self, tensors: Sequence[Any]) -> List[Any]:
        if not self._is_cuda():
            dev = self._device or torch.device("cpu")
            staged = [as_torch(t).to(dev) for t in tensors]
            with self._lock:
                self.puts += 1
                self.put_bytes += sum(t.numel() * t.element_size()
                                      for t in staged)
            return staged
        if self.min_bytes and self.host_bytes(tensors) < self.min_bytes:
            return self._direct(tensors)
        with self._lock:
            return self._stage_cuda(tensors)

    @staticmethod
    def host_bytes(tensors: Sequence[Any]) -> int:
        """Bytes of the frame's tensors that are not on a card."""
        return sum(as_torch(t).nbytes for t in tensors
                   if not (isinstance(t, torch.Tensor) and t.is_cuda))

    def _direct(self, tensors) -> List[Any]:
        """A frame under ``min_bytes``: host tensors stay on the host for
        the consumer to copy (in the ledger as a staged copy is), device
        tensors reach the stager's card."""
        dev = self._device
        out: List[Any] = []
        moved = 0
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                out.append(t if t.device == dev
                           else t.to(dev, non_blocking=True))
                continue
            t = as_torch(t)
            moved += t.nbytes
            out.append(t)
        with self._lock:
            self.direct += 1
        _note_h2d(moved)
        return out

    def _stage_cuda(self, tensors) -> List[Any]:  # holds _lock
        dev = self._device
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        side = self._side
        consumer = torch.cuda.current_stream(dev)
        slot = self._slots[self._turn]
        self._turn = (self._turn + 1) % self._depth
        if slot.done is not None:
            # this slot's previous copy (two frames ago) must have left
            # the pinned buffer before the host rewrites it
            # nnlint: disable=NNL203 — this slot's copy of two frames ago must
            # leave the pinned buffer before the host rewrites it: one event,
            # already done in steady state
            slot.done.synchronize()
        staged: List[Any] = []
        moved = 0
        pending = []
        for i, t in enumerate(tensors):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                staged.append(t if t.device == dev
                              else t.to(dev, non_blocking=True))
                continue
            host = as_torch(t)
            while len(slot.pinned) <= i:
                slot.pinned.append(None)
            pin = slot.pinned[i]
            if pin is None or pin.shape != host.shape or pin.dtype != host.dtype:
                pin = slot.pinned[i] = torch.empty(
                    host.shape, dtype=host.dtype, pin_memory=True)
            pin.copy_(host)
            pending.append((len(staged), pin))
            staged.append(None)
            moved += pin.numel() * pin.element_size()
        if pending:
            with torch.cuda.stream(side):
                for idx, pin in pending:
                    d = torch.empty(pin.shape, dtype=pin.dtype, device=dev)
                    d.copy_(pin, non_blocking=True)
                    # the consumer stream frees it; order that free
                    d.record_stream(consumer)
                    staged[idx] = d
                done = torch.cuda.Event()
                done.record(side)
            slot.done = done
            consumer.wait_event(done)
            self.puts += 1
            self.put_bytes += moved
        if moved:
            _note_h2d(moved)
        return staged

    def drain(self) -> None:
        """Release every pinned slot and the side stream (segment
        teardown / backend close). Each slot's last copy is waited for
        first: the card may still read its pinned buffer."""
        with self._lock:
            for slot in self._slots:
                if slot.done is not None:
                    # nnlint: disable=NNL203 — teardown, not the hot path: the
                    # last copy out of a pinned buffer must end before it is freed
                    slot.done.synchronize()
            self._slots = [_Slot() for _ in range(self._depth)]
            self._turn = 0
            self._side = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"puts": self.puts, "put_bytes": self.put_bytes,
                    "depth": self._depth}
