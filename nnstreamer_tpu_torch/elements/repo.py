"""tensor_repo_sink / tensor_repo_src: in-process circular streams (L3).

Reference analog: ``gsttensor_repo.c`` (394 LoC) + ``gsttensor_reposink.c`` /
``gsttensor_reposrc.c`` — a shared, slot-keyed tensor repository enabling
RNN-style feedback loops: a downstream repo_sink writes a slot, an upstream
repo_src replays it into the next iteration (GMutex/GCond per slot,
gsttensor_repo.h:44-62).

The counterpart of nnstreamer_tpu's ``elements/repo.py``: slots hold
buffers by reference, so CUDA tensors stay on their card.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional

from ..core import (
    Buffer,
    Caps,
    DataType,
    TensorsInfo,
    caps_from_tensors_info,
    parse_caps_string,
    tensors_info_from_caps,
)
from ..registry.elements import register_element
from ..runtime.element import (
    ElementError,
    Prop,
    SinkElement,
    SourceElement,
    prop_bool,
)
from ..runtime.pad import PadDirection, PadTemplate


def _check_slot_index(el) -> None:
    # reference gst_tensor_repo negative corpus: a negative slot id is a
    # hard error at construction, not a silently-created slot
    if el.props["slot_index"] < 0:
        raise ElementError(
            f"{el.describe()}: slot-index={el.props['slot_index']} "
            "must be >= 0")


class _Slot:
    def __init__(self, depth: int = 2):
        self.q: Deque[Buffer] = deque(maxlen=depth)
        self.cond = threading.Condition()
        self.eos = False

    def push(self, buf: Buffer) -> None:
        with self.cond:
            self.q.append(buf)
            self.cond.notify_all()

    def pop(self, timeout: float) -> Optional[Buffer]:
        deadline = time.monotonic() + timeout
        with self.cond:
            # predicate loop: a spurious wakeup (or a notify consumed by
            # another waiter) must re-wait the REMAINING budget, not
            # return an early None
            while not self.q and not self.eos:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.cond.wait(remaining)
            return self.q.popleft() if self.q else None

    def set_eos(self) -> None:
        with self.cond:
            self.eos = True
            self.cond.notify_all()


class TensorRepo:
    """Global slot table (reference's process-wide repo + repo_lock)."""

    def __init__(self):
        self._slots: Dict[int, _Slot] = {}
        self._lock = threading.Lock()

    def slot(self, idx: int) -> _Slot:
        with self._lock:
            if idx not in self._slots:
                self._slots[idx] = _Slot()
            return self._slots[idx]

    def reset(self) -> None:
        with self._lock:
            self._slots.clear()


REPO = TensorRepo()


@register_element
class TensorRepoSink(SinkElement):
    ELEMENT_NAME = "tensor_repo_sink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    PROPERTIES = {
        "slot_index": Prop(0, int, "repository slot id"),
        # reference gsttensor_reposink.c signal-rate: cap repo updates per
        # second of stream time (0 = every buffer)
        "signal_rate": Prop(0, int,
                            "max repo updates per second of pts "
                            "(0 = every buffer)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        _check_slot_index(self)

    def reset_flow(self) -> None:
        super().reset_flow()
        # replayed pipelines restart pts at 0: a stale throttle epoch
        # would mute the repo slot until pts passed the old run's
        self._last_push_pts = None

    def render(self, buf: Buffer) -> None:
        rate = self.props["signal_rate"]
        if rate > 0 and buf.pts is not None:
            last = getattr(self, "_last_push_pts", None)
            if last is not None and (buf.pts - last) < 1.0 / rate:
                return
            self._last_push_pts = buf.pts
        REPO.slot(self.props["slot_index"]).push(buf)

    def handle_eos(self) -> None:
        REPO.slot(self.props["slot_index"]).set_eos()
        super().handle_eos()


@register_element
class TensorRepoSrc(SourceElement):
    ELEMENT_NAME = "tensor_repo_src"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, Caps.new("other/tensors")),)
    PROPERTIES = {
        "slot_index": Prop(0, int, "repository slot id"),
        "caps": Prop(None, str, "stream caps (repo carries no negotiation)"),
        "timeout": Prop(5.0, float, "seconds to wait per frame before EOS"),
        "initial_dummy": Prop(False, prop_bool,
                              "emit one ZERO buffer before the slot's first "
                              "frame — bootstraps mux-feedback (RNN/LSTM) "
                              "loops that would otherwise deadlock on frame "
                              "0 (reference reposrc does this always, "
                              "gsttensor_reposrc.c:287-338)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._primed = False
        _check_slot_index(self)

    def reset_flow(self) -> None:
        super().reset_flow()
        self._primed = False

    def get_src_caps(self) -> Caps:
        if not self.props["caps"]:
            raise ValueError(f"{self.describe()}: caps property required")
        return parse_caps_string(self.props["caps"])

    def _dummy_buffer(self) -> Buffer:
        """Zeros shaped from the declared caps (the reference's
        gen_dummy_buffer: memset-0 memories per tensor)."""
        import numpy as np
        import torch

        info = tensors_info_from_caps(parse_caps_string(self.props["caps"]))
        if not info.specs or any(None in s.shape or not s.shape
                                 for s in info.specs):
            raise ValueError(
                f"{self.describe()}: initial-dummy requires fully-fixated "
                "static caps to shape the zero buffer")
        # numpy has no bfloat16: its zeros are a CPU torch tensor
        return Buffer([torch.zeros(tuple(s.shape), dtype=torch.bfloat16)
                       if s.dtype is DataType.BFLOAT16
                       else np.zeros(tuple(s.shape), s.dtype.np_dtype)
                       for s in info.specs])

    def create(self) -> Optional[Buffer]:
        import time

        if self.props["initial_dummy"] and not self._primed:
            self._primed = True
            return self._dummy_buffer()
        slot = REPO.slot(self.props["slot_index"])
        timeout = self.props["timeout"]
        deadline = time.monotonic() + timeout if timeout > 0 else None
        while self.running:
            buf = slot.pop(timeout=0.1)
            if buf is not None:
                return buf
            if slot.eos:
                return None
            if deadline is not None and time.monotonic() >= deadline:
                return None  # documented per-frame timeout: stream ends
        return None


@register_element
class TensorRepoSinkAlias(TensorRepoSink):
    """The reference's element name (``tensor_reposink``) for
    :class:`TensorRepoSink` — its launch lines run unchanged."""

    ELEMENT_NAME = "tensor_reposink"


@register_element
class TensorRepoSrcAlias(TensorRepoSrc):
    """The reference's element name (``tensor_reposrc``)."""

    ELEMENT_NAME = "tensor_reposrc"
