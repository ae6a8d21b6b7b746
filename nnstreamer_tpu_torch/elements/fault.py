"""tensor_fault: deterministic fault injection for chaos testing (L3).

The port of nnstreamer_tpu's ``elements/fault.py``: a passthrough that —
driven by a SEEDED numpy rng (``default_rng(seed)``, so drops, delays,
corruption and duplicates fall on the same buffers as in the reference)
— drops, delays, duplicates, or corrupts buffers with configured
probabilities.

Properties: ``drop-prob``, ``dup-prob``, ``corrupt-prob`` (flip a random
byte span in a COPY of the tensor — upstream data is never mutated),
``delay-ms`` (uniform 0..delay per affected buffer, ``delay-prob``
gated), ``seed``. Counters ride on the element: ``.stats`` dict.

Crash modes (supervised-restart chaos): ``crash-at-buffer`` raises on
the Nth buffer of a run, one-shot unless ``crash-repeat`` re-arms it.

Numerical-fault modes (data-plane quality chaos, ``obs/quality.py``):
``nan-at-buffer`` / ``inf-at-buffer`` poison float tensors from the Nth
buffer on, ``scale-drift=<factor>`` silently rescales them — failures
the stream survives but the numbers don't, which is exactly what the
quality taps and drift scoring must detect. Like the reference, these
modes work on the host copy (``Buffer.as_numpy``): a bfloat16 tensor,
which is a CPU ``torch.bfloat16`` there (the reference's an
``ml_dtypes`` array, not a numpy float), passes untouched.

Network-fault modes (:data:`net_chaos`, a process-global
:class:`NetworkChaos`) inject faults BETWEEN pipelines, on the TCP
links of the tensor-query transports:

* ``drop_conn_at(port, n)`` — kill the connection after ``n`` more DATA
  frames touch it;
* ``delay_ms(port, ms)`` — every send to/from the port sleeps first;
* ``partition_for_s(port, s)`` — connects and sends involving the port
  fail for the window (heals by itself).

All modes key on a TCP port (either endpoint of the link matches).
Arming installs ``NetworkChaos._on_send`` / ``_on_connect`` into
``query/protocol.py`` (consulted only while armed: disarmed costs one
attribute read per send); ``clear()`` disarms everything and uninstalls
the hooks.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..analysis.sanitizer import named_lock
from ..core import Buffer
from ..core.caps import any_media_caps
from ..registry.elements import register_element
from ..runtime.element import Element, Prop, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate


class NetworkChaos:
    """Process-global network fault injector for the query transports.

    Rules are keyed by TCP port and matched against BOTH endpoints of a
    socket, so ``drop_conn_at(server_port, ...)`` hits the link no
    matter which side sends. Arming installs the protocol hooks;
    :meth:`clear` uninstalls them (zero steady-state overhead outside a
    chaos run)."""

    def __init__(self):
        self._lock = named_lock("NetworkChaos._lock")
        self._rules: Dict[int, dict] = {}  # port -> rule  guarded-by: _lock
        self._armed = False                # guarded-by: _lock
        self.stats = {"killed_conns": 0, "delayed_sends": 0,
                      "partition_refusals": 0}  # guarded-by: _lock

    # -- arming --------------------------------------------------------------
    def _arm(self) -> None:
        from ..query import protocol

        with self._lock:
            if self._armed:
                return
            self._armed = True
        protocol.set_fault_hooks(send=self._on_send,
                                 connect=self._on_connect)

    def clear(self) -> None:
        """Disarm every rule and uninstall the transport hooks."""
        from ..query import protocol

        with self._lock:
            self._rules.clear()
            self._armed = False
        protocol.set_fault_hooks(None, None)

    def _rule(self, port: int) -> dict:
        # caller holds _lock
        r = self._rules.get(port)
        if r is None:
            r = self._rules[port] = {"drop_countdown": None, "delay_s": 0.0,
                                     "partition_until": 0.0}
        return r

    # -- modes ---------------------------------------------------------------
    def drop_conn_at(self, port: int, n_frames: int = 0) -> None:
        """Kill the next connection touching ``port`` after ``n_frames``
        more DATA frames cross it (0 = on the very next frame)."""
        with self._lock:
            self._rule(port)["drop_countdown"] = int(n_frames)
        self._arm()

    def delay_ms(self, port: int, ms: float) -> None:
        """Every send on a link touching ``port`` sleeps ``ms`` first
        (slow replica / congested link). 0 removes the delay."""
        with self._lock:
            self._rule(port)["delay_s"] = float(ms) / 1e3
        self._arm()

    def partition_for_s(self, port: int, seconds: float) -> None:
        """Connects and sends involving ``port`` fail for ``seconds``
        (the partition heals by itself — readmission probes then
        succeed)."""
        with self._lock:
            self._rule(port)["partition_until"] = (
                time.monotonic() + float(seconds))
        self._arm()

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": self._armed, "rules": len(self._rules),
                    **self.stats}

    # -- transport hooks (installed in query/protocol.py while armed) --------
    def _on_connect(self, host: str, port: int) -> None:
        with self._lock:
            rule = self._rules.get(port)
            partitioned = (rule is not None
                           and time.monotonic() < rule["partition_until"])
            if partitioned:
                self.stats["partition_refusals"] += 1
        if partitioned:
            raise ConnectionRefusedError(
                f"chaos: endpoint port {port} is partitioned")

    def _on_send(self, sock, msg_type) -> None:
        """``msg_type`` is the transport's message type; DATA frames
        (``msg_type.name == "DATA"``) count down ``drop_conn_at``."""
        is_data = getattr(msg_type, "name", msg_type) == "DATA"
        try:
            ports = (sock.getpeername()[1], sock.getsockname()[1])
        except OSError:
            return  # socket already dead; let sendall report it
        delay_s = 0.0
        kill = None  # (reason, port)
        with self._lock:
            for p in ports:
                rule = self._rules.get(p)
                if rule is None:
                    continue
                if time.monotonic() < rule["partition_until"]:
                    self.stats["partition_refusals"] += 1
                    kill = ("partitioned", p)
                    break
                cd = rule["drop_countdown"]
                if cd is not None and is_data:
                    if cd <= 0:
                        rule["drop_countdown"] = None  # one-shot
                        self.stats["killed_conns"] += 1
                        kill = ("connection killed", p)
                        break
                    rule["drop_countdown"] = cd - 1
                if rule["delay_s"] > 0:
                    delay_s = max(delay_s, rule["delay_s"])
                    self.stats["delayed_sends"] += 1
        if kill is not None:
            reason, p = kill
            from ..query.server import _shutdown_close

            _shutdown_close(sock)  # FIN both ways: the peer's reader wakes
            raise ConnectionResetError(
                f"chaos: {reason} (port {p})")
        if delay_s > 0:
            time.sleep(delay_s)  # outside _lock: never stall other links


#: the process-global injector chaos runs drive
net_chaos = NetworkChaos()


def _is_host_bf16(t) -> bool:
    """A host bfloat16 tensor: a CPU ``torch.bfloat16`` (core/buffer.py);
    the reference's is an ``ml_dtypes`` array."""
    return isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16


def _host(t):
    """A host tensor as numpy: a CPU torch tensor (a filter's output
    under ``accelerator=cpu``) is the reference's jax array, which its
    ``as_numpy`` turns into numpy."""
    return t.numpy() if isinstance(t, torch.Tensor) else t


@register_element
class TensorFault(Element):
    ELEMENT_NAME = "tensor_fault"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, any_media_caps()),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, any_media_caps()),)
    PROPERTIES = {
        "drop_prob": Prop(0.0, float, "probability a buffer is dropped"),
        "dup_prob": Prop(0.0, float, "probability a buffer is sent twice"),
        "corrupt_prob": Prop(0.0, float,
                             "probability a buffer's bytes are corrupted "
                             "(copy-on-write; shapes/dtypes preserved)"),
        "delay_prob": Prop(0.0, float, "probability a buffer is delayed"),
        "delay_ms": Prop(0.0, float, "max delay (uniform 0..delay-ms)"),
        "seed": Prop(0, int, "rng seed — identical runs inject identical faults"),
        # deterministic element-crash injection (supervised-restart chaos
        # tests): raise on the Nth buffer of a run. One-shot by default —
        # the crash DISARMS across reset_flow, so a supervisor replaying
        # the same pipeline recovers; crash-repeat=true re-arms every run
        # (circuit-breaker tests)
        "crash_at_buffer": Prop(-1, int,
                                "raise on this 0-based buffer index "
                                "(-1 = never)"),
        "crash_repeat": Prop(False, prop_bool,
                             "re-arm the crash on every (re)start instead "
                             "of one-shot"),
        # numerical-fault modes (data-plane quality chaos, obs/quality.py):
        # unlike the crash modes these are SILENT failures — the pipeline
        # keeps flowing, only the numbers go bad — exactly what the
        # quality taps / drift scoring / canary gate must catch E2E
        "nan_at_buffer": Prop(-1, int,
                              "poison float tensors with NaN from this "
                              "0-based buffer index on (-1 = never; "
                              "copy-on-write, shapes/dtypes preserved)"),
        "inf_at_buffer": Prop(-1, int,
                              "poison float tensors with Inf from this "
                              "0-based buffer index on (-1 = never)"),
        "scale_drift": Prop(1.0, float,
                            "multiply every float tensor by this factor "
                            "(1.0 = off) — silent distribution-drift "
                            "injection"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._rng = np.random.default_rng(self.props["seed"])
        self.stats = {"passed": 0, "dropped": 0, "duplicated": 0,
                      "corrupted": 0, "delayed": 0, "crashed": 0,
                      "nan_injected": 0, "inf_injected": 0, "scaled": 0}
        self._buf_index = 0
        self._crash_armed = self.props["crash_at_buffer"] >= 0

    def reset_flow(self) -> None:
        super().reset_flow()
        self._rng = np.random.default_rng(self.props["seed"])
        crashed = self.stats.get("crashed", 0)
        self.stats = {k: 0 for k in self.stats}
        self._buf_index = 0
        if self.props["crash_repeat"]:
            self._crash_armed = self.props["crash_at_buffer"] >= 0
        elif crashed:
            self._crash_armed = False  # one-shot: stays disarmed on replay

    def _corrupt(self, buf: Buffer) -> Buffer:
        tensors = []
        for t in buf.as_numpy().tensors:
            if _is_host_bf16(t):
                # its bytes, as the reference corrupts an ml_dtypes array's
                a = t.contiguous().clone()
                flat = a.view(torch.int16).numpy().reshape(-1).view(np.uint8)
            else:
                a = np.array(_host(t), copy=True)
                flat = a.reshape(-1).view(np.uint8)
            if flat.size:
                span = max(1, flat.size // 16)
                start = int(self._rng.integers(0, max(flat.size - span, 1)))
                flat[start:start + span] = self._rng.integers(
                    0, 256, min(span, flat.size - start), dtype=np.uint8)
            tensors.append(a)
        out = Buffer(tensors).copy_metadata_from(buf)
        return out

    def _numeric_faults(self, buf: Buffer, idx: int) -> Buffer:
        """Silent numerical poisoning (copy-on-write): NaN/Inf flood a
        deterministic 1/16 span of every FLOAT tensor from the armed
        index on, scale-drift multiplies whole float tensors. Integer
        tensors pass untouched (no NaN/Inf representation; a drifted
        int distribution is the corrupt-prob mode's job)."""
        p = self.props
        nan_on = 0 <= p["nan_at_buffer"] <= idx
        inf_on = 0 <= p["inf_at_buffer"] <= idx
        scale = p["scale_drift"]
        if not nan_on and not inf_on and scale == 1.0:
            return buf
        tensors = []
        touched = False
        for t in buf.as_numpy().tensors:
            if _is_host_bf16(t):
                tensors.append(t)  # not a numpy float in the reference
                continue
            a = np.asarray(_host(t))
            if a.dtype.kind != "f":
                tensors.append(a)
                continue
            a = np.array(a, copy=True)
            if scale != 1.0:
                a *= np.asarray(scale, dtype=a.dtype)
            flat = a.reshape(-1)
            span = max(1, flat.size // 16)
            if nan_on:
                flat[:span] = np.nan
            if inf_on:
                # disjoint span so both poisons land when both are armed
                lo = span if nan_on else 0
                flat[lo:lo + span] = np.inf
            tensors.append(a)
            touched = True
        if not touched:
            return buf
        if nan_on:
            self.stats["nan_injected"] += 1
        if inf_on:
            self.stats["inf_injected"] += 1
        if scale != 1.0:
            self.stats["scaled"] += 1
        return Buffer(tensors).copy_metadata_from(buf)

    def chain(self, pad: Pad, buf: Buffer) -> None:
        idx = self._buf_index
        self._buf_index += 1
        if self._crash_armed and idx == self.props["crash_at_buffer"]:
            self.stats["crashed"] += 1
            if not self.props["crash_repeat"]:
                self._crash_armed = False
            raise RuntimeError(
                f"injected crash at buffer {idx} (tensor_fault "
                "crash-at-buffer)")
        r = self._rng.random(4)
        if r[0] < self.props["drop_prob"]:
            self.stats["dropped"] += 1
            return
        if r[1] < self.props["delay_prob"] and self.props["delay_ms"] > 0:
            self.stats["delayed"] += 1
            time.sleep(float(self._rng.random()) * self.props["delay_ms"] / 1e3)
        if r[2] < self.props["corrupt_prob"]:
            self.stats["corrupted"] += 1
            buf = self._corrupt(buf)
        buf = self._numeric_faults(buf, idx)
        self.stats["passed"] += 1
        self.push(buf)
        if r[3] < self.props["dup_prob"]:
            self.stats["duplicated"] += 1
            # a fresh Buffer object: downstream elements that stamp buffers
            # in place (tensor_shard seq/offset) must not alias the first
            self.push(Buffer(list(buf.tensors)).copy_metadata_from(buf))
