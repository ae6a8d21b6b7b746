"""Data-plane counters (L5 → obs).

The counterpart of nnstreamer_tpu's ``transport/stats.py``, plus ``d2h``:
card tensors the encoder pulled to the host (count and bytes).

One process-wide tally of what the negotiated transports actually did —
connections per wire format, frames/bytes per format and direction, shm
slot traffic and fallbacks. The ``obs/metrics.py`` ``wire`` collector
renders these as ``nns_wire_*`` / ``nns_shm_*`` promtext series every
scrape, which is how a fleet silently stuck on the JSON fallback
becomes visible in ``obs fleet`` / ``obs top`` (a replica whose
``nns_wire_connections{format="json"}`` never drops to zero is the
smoking gun). Counters are ints under one lock — the send path adds two
dict updates per frame, nothing more."""
from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()

# negotiated-format lifecycle: active connection gauge + all-time totals
_active: Dict[str, int] = {}
_negotiated: Dict[str, int] = {}
# per (format, direction) frame/byte tallies
_frames: Dict[tuple, int] = {}
_bytes: Dict[tuple, int] = {}
# shm ring events: slot_writes, bytes, fallback_full, fallback_oversize,
# reclaimed_slots, segments_created, segments_attached, segments_closed,
# stale_descriptors
_shm: Dict[str, int] = {}
# card tensors the frame encoder pulled to the host: tensors, bytes
_d2h: Dict[str, int] = {}


def note_connection(fmt: str) -> None:
    """A connection finished negotiation on ``fmt``. pairs-with:
    :func:`drop_connection` on disconnect (gauge balance)."""
    with _lock:
        _active[fmt] = _active.get(fmt, 0) + 1
        _negotiated[fmt] = _negotiated.get(fmt, 0) + 1


def drop_connection(fmt: str) -> None:
    with _lock:
        _active[fmt] = max(0, _active.get(fmt, 0) - 1)


def note_frame(fmt: str, direction: str, nbytes: int) -> None:
    """One DATA frame moved (``direction`` ``"tx"``/``"rx"``)."""
    key = (fmt, direction)
    with _lock:
        _frames[key] = _frames.get(key, 0) + 1
        _bytes[key] = _bytes.get(key, 0) + nbytes


def note_shm(event: str, n: int = 1) -> None:
    with _lock:
        _shm[event] = _shm.get(event, 0) + n


def note_d2h(nbytes: int) -> None:
    """One card tensor copied to the host by the frame encoder."""
    with _lock:
        _d2h["tensors"] = _d2h.get("tensors", 0) + 1
        _d2h["bytes"] = _d2h.get("bytes", 0) + nbytes


def snapshot() -> dict:
    """Point-in-time copy for the metrics collector / control API."""
    with _lock:
        return {
            "connections": dict(_active),
            "negotiated": dict(_negotiated),
            "frames": {f"{f}:{d}": v for (f, d), v in _frames.items()},
            "bytes": {f"{f}:{d}": v for (f, d), v in _bytes.items()},
            "shm": dict(_shm),
            "d2h": dict(_d2h),
        }


def reset() -> None:
    """Zero everything (test isolation)."""
    with _lock:
        _active.clear()
        _negotiated.clear()
        _frames.clear()
        _bytes.clear()
        _shm.clear()
        _d2h.clear()
