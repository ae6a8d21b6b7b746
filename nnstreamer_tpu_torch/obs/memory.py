"""Device-memory accounting for the serving plane (L7).

The part of nnstreamer_tpu's ``obs/memory.py`` that the serving engines
and schedulers call:

* :func:`tree_nbytes` — bytes of a parameter dict or KV cache (nested
  dicts, lists and tuples of torch tensors or numpy arrays);
* :func:`track_serving` — serving byte sources (the continuous LM engines'
  slot caches and page pools, admission guards) register weakly; anything
  with ``memory_bytes() -> dict`` qualifies;
* :class:`AdmissionGuard` — the schedulers' projected-bytes gate: a
  request whose reservation would cross ``watermark × budget`` is shed
  with a typed ``MemoryPressureError`` at submit time instead of running
  the card out of memory mid-batch;
* :func:`sample_devices` — live bytes per CUDA device from
  ``torch.cuda.memory_stats`` (allocated bytes) and ``torch.cuda.
  mem_get_info`` (the card's total, the budget), with per-device
  high-water marks and ``memory`` flight events on watermark crossings;
* :func:`snapshot` and the ``nns_memory_{device,device_peak,
  device_used_fraction,serving}_bytes`` gauges they feed.

Not in this package yet: the per-stage static estimates, the
``MemoryAccountant``, queue occupancy bytes, the calibration windows and
the ``obs top`` section, which come with the profiler and the placement
planner.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import torch

from ..analysis import sanitizer as _san
from ..analysis.sanitizer import named_lock
from . import flight as obs_flight
from . import metrics as obs_metrics

#: fraction of the budget at which a ``memory`` flight event fires
DEFAULT_WATERMARK = 0.9


def tree_nbytes(tree) -> int:
    """Sum of leaf tensor bytes of a nested dict / list / tuple (params
    dicts, KV caches); torch tensors count ``numel × element_size``,
    anything else its ``nbytes`` if it has one."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return int(tree.numel() * tree.element_size())
    nbytes = getattr(tree, "nbytes", None)
    return nbytes if isinstance(nbytes, int) else 0


class _DeviceWatermarks:
    """Per-device high-water marks + crossing state for flight events."""

    def __init__(self):
        self._lock = named_lock("_DeviceWatermarks._lock")
        self._peak: Dict[str, int] = {}      # guarded-by: _lock
        self._crossed: Dict[str, bool] = {}  # guarded-by: _lock

    def update(self, label: str, bytes_in_use: int, budget: int,
               watermark: float) -> int:
        """Fold one sample; returns the device's peak. Watermark
        crossings (both directions) land as ``memory`` flight events."""
        with self._lock:
            peak = self._peak.get(label, 0)
            if bytes_in_use > peak:
                peak = self._peak[label] = bytes_in_use
            was = self._crossed.get(label, False)
            now = bytes_in_use > watermark * budget
            self._crossed[label] = now
        if now and not was:
            obs_flight.record("memory", "watermark",
                              {"device": label, "bytes": bytes_in_use,
                               "budget": budget, "watermark": watermark})
        elif was and not now:
            obs_flight.record("memory", "watermark_clear",
                              {"device": label, "bytes": bytes_in_use,
                               "budget": budget})
        return peak



_watermarks = _DeviceWatermarks()


def sample_devices(watermark: float = DEFAULT_WATERMARK) -> List[dict]:
    """One live sample per CUDA device: ``bytes_in_use`` is the caching
    allocator's allocated bytes (``torch.cuda.memory_stats``), the budget
    the card's total memory (``torch.cuda.mem_get_info``). Updates the
    per-device watermarks. No card (or no CUDA build): an empty list."""
    if not torch.cuda.is_available():
        return []
    rows: List[dict] = []
    for i in range(torch.cuda.device_count()):
        label = f"cuda:{i}"
        stats = torch.cuda.memory_stats(i)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        free, budget = torch.cuda.mem_get_info(i)
        peak = _watermarks.update(label, in_use, budget, watermark)
        rows.append({
            "device": label,
            "bytes_in_use": in_use,
            "peak_bytes": peak,
            "budget_bytes": int(budget),
            "free_bytes": int(free),
            "used_fraction": in_use / budget,
            "source": "torch.cuda",
        })
    return rows


_tracked_serving: "weakref.WeakSet" = weakref.WeakSet()


def track_serving(source) -> None:
    """Register a serving byte source: anything with ``memory_bytes()``
    -> dict. Weakly held — closed sources drop out."""
    _tracked_serving.add(source)


def serving_bytes() -> Dict[str, dict]:
    """{source name: its ``memory_bytes()``} over every live source."""
    out: Dict[str, dict] = {}
    for src in list(_tracked_serving):
        try:
            snap = src.memory_bytes()
        except Exception:  # noqa: BLE001 - source mid-close
            continue
        name = snap.get("name", type(src).__name__)
        if name in out:
            name = f"{name}#{sum(1 for k in out if k.startswith(name))}"
        out[name] = snap
    return out


class AdmissionGuard:
    """Projected-bytes admission gate for the serving schedulers: every
    admitted request reserves its bytes (× ``overhead`` for activations and
    padding) until completion; a reservation that would push the total
    past ``watermark × budget_bytes`` is refused and the scheduler sheds
    the request with a typed ``MemoryPressureError``. Thread-safe; shows
    its state in the memory snapshot via :func:`track_serving`."""

    def __init__(self, budget_bytes: int,
                 watermark: float = DEFAULT_WATERMARK,
                 overhead: float = 2.0, name: str = "guard"):
        if budget_bytes < 1:
            raise ValueError(f"budget_bytes={budget_bytes} must be >= 1")
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark={watermark} must be in (0, 1]")
        self.budget_bytes = int(budget_bytes)
        self.watermark = watermark
        self.overhead = overhead
        self.name = name
        self._lock = named_lock(f"AdmissionGuard._lock:{name}")
        self._inflight = 0   # guarded-by: _lock
        self._peak = 0       # guarded-by: _lock
        self.shed = 0        # guarded-by: _lock
        track_serving(self)

    @property
    def limit_bytes(self) -> int:
        return int(self.watermark * self.budget_bytes)

    def reserve(self, nbytes: int) -> bool:   # pairs-with: release
        """Reserve ``nbytes × overhead``; False = would cross the
        watermark (caller sheds)."""
        need = int(nbytes * self.overhead)
        with self._lock:
            if self._inflight + need > self.limit_bytes:
                self.shed += 1
                return False
            self._inflight += need
            if self._inflight > self._peak:
                self._peak = self._inflight
        if _san.LEAK:
            _san.note_acquire("guard_reservation", self.name,
                              detail=f"{need} bytes")
        return True

    def release(self, nbytes: int) -> None:
        need = int(nbytes * self.overhead)
        with self._lock:
            self._inflight = max(0, self._inflight - need)
        if _san.LEAK:
            _san.note_release("guard_reservation", self.name)

    @property
    def inflight_bytes(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def memory_bytes(self) -> dict:
        with self._lock:
            return {"name": f"guard:{self.name}", "kind": "admission_guard",
                    "bytes": self._inflight, "peak_bytes": self._peak,
                    "budget_bytes": self.budget_bytes,
                    "limit_bytes": self.limit_bytes, "shed": self.shed}


def snapshot() -> dict:
    """Live device samples + watermarks and the serving byte sources."""
    return {
        "devices": sample_devices(),
        "serving": serving_bytes(),
    }


_G_DEVICE = obs_metrics.gauge(
    "nns_memory_device_bytes", "live device buffer bytes", ("device",))
_G_DEVICE_PEAK = obs_metrics.gauge(
    "nns_memory_device_peak_bytes", "per-device high-water mark",
    ("device",))
_G_DEVICE_FRAC = obs_metrics.gauge(
    "nns_memory_device_used_fraction",
    "live bytes over the device budget (0 when no budget known)",
    ("device",))
_G_SERVING = obs_metrics.gauge(
    "nns_memory_serving_bytes",
    "serving-plane byte sources (KV caches, admission reservations)",
    ("source",))


def _collect_memory(_registry) -> None:
    for g in (_G_DEVICE, _G_DEVICE_PEAK, _G_DEVICE_FRAC, _G_SERVING):
        g.clear()
    for row in sample_devices():
        _G_DEVICE.set(row["bytes_in_use"], device=row["device"])
        _G_DEVICE_PEAK.set(row["peak_bytes"], device=row["device"])
        _G_DEVICE_FRAC.set(row["used_fraction"], device=row["device"])
    for name, snap in serving_bytes().items():
        _G_SERVING.set(snap.get("bytes", 0), source=name)


obs_metrics.register_collector("memory", _collect_memory)
