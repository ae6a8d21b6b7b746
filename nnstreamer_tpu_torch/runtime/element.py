"""Element base classes (L0' substrate).

Reference analog: GstElement/GstBaseTransform/GstBaseSrc/GstBaseSink, which
every reference element subclasses (e.g. ``tensor_filter.c:107``
``G_DEFINE_TYPE (..., GST_TYPE_BASE_TRANSFORM)``). GObject properties become a
declarative ``PROPERTIES`` table; caps negotiation is event-driven: when all
sink pads of an element carry fixed caps, the element computes its source caps
(``transform_caps``) and forwards a CAPS event downstream.
"""
from __future__ import annotations

import os
import threading
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..analysis.sanitizer import named_lock
from ..core import Buffer, Caps, Event, EventType, Message, MessageType
from ..utils.log import logger
from .pad import Pad, PadDirection, PadPresence, PadTemplate


@dataclass
class Prop:
    """Declarative element property (GObject property analog)."""

    default: Any = None
    convert: Optional[Callable[[Any], Any]] = None
    doc: str = ""


def prop_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


class ElementError(RuntimeError):
    pass


class Element:
    """Base of every pipeline element.

    Subclasses declare:
      * ``ELEMENT_NAME`` — factory name used in launch strings;
      * ``SINK_TEMPLATES`` / ``SRC_TEMPLATES`` — pad templates;
      * ``PROPERTIES`` — launch-string-settable properties;
    and implement ``chain`` (data), optionally ``set_caps``/``transform_caps``
    (negotiation) and ``start``/``stop`` (lifecycle).
    """

    ELEMENT_NAME: str = ""
    SINK_TEMPLATES: Sequence[PadTemplate] = ()
    SRC_TEMPLATES: Sequence[PadTemplate] = ()
    # where this element's steady-state compute runs. "device": PyTorch
    # compute on the element's card, buffers stay device-resident
    # (tensor_filter/tensor_serving/tensor_transform); "host": must pull
    # buffers to host memory to do its work (decoders, media
    # converters); "neutral": works on whatever arrives without forcing
    # a transfer (queues, tees, sinks)
    DEVICE_AFFINITY: str = "neutral"
    # fusion contract (runtime/fusion.py): device-affinity elements are
    # fused into one-dispatch segments by default; STATEFUL device
    # elements whose per-buffer behavior cannot be expressed as a pure
    # per-buffer function (cross-buffer batching, RNG state) set False
    FUSABLE: bool = True
    # optional class-level barrier message the fusion planner reports
    # instead of the generic affinity/FUSABLE reason — e.g. queue's
    # "queue boundary"
    FUSION_BARRIER: Optional[str] = None
    # alternate property spellings (reference/GStreamer names) mapped to
    # the canonical key, applied after dash→underscore normalization
    PROP_ALIASES: Dict[str, str] = {}
    PROPERTIES: Dict[str, Prop] = {
        # reference: every tensor element carries `silent` (verbose
        # per-buffer logging when false, e.g. gsttensor_converter.c:263)
        "silent": Prop(True, prop_bool, "suppress per-buffer flow logging"),
    }

    _instance_count = 0
    _count_lock = threading.Lock()

    def __init__(self, name: Optional[str] = None, **props):
        cls = type(self)
        # the auto-name carries a PROCESS-global counter, so it is not
        # stable across restarts/replicas — the profiler's canonical
        # naming (obs/profile.py series_name) substitutes a positional
        # alias for auto-named elements
        self.auto_named = name is None
        if name is None:
            with Element._count_lock:
                Element._instance_count += 1
                name = f"{cls.ELEMENT_NAME or cls.__name__.lower()}{Element._instance_count}"
        self.name = name
        self.pipeline = None  # set by Pipeline.add
        self.sink_pads: List[Pad] = []
        self.src_pads: List[Pad] = []
        # per-instance name: EOS can cascade element-to-element, and two
        # elements' latches must stay distinct lock-order graph nodes
        self._lock = named_lock(f"Element._lock:{name}")
        self._eos_sent = False  # guarded-by: _lock
        # fusion annotations (runtime/fusion.py, set by fusion.install):
        # _fusion_head routes this element's incoming buffers through one
        # fused dispatch; _fusion_member links every segment element for
        # cache invalidation on caps/model changes
        self._fusion_head = None
        self._fusion_member = None
        self.props: Dict[str, Any] = {}
        merged: Dict[str, Prop] = {}
        for klass in reversed(cls.__mro__):
            merged.update(getattr(klass, "PROPERTIES", {}) or {})
        self._prop_defs = merged
        for pname, p in merged.items():
            self.props[pname] = p.default
        for k, v in props.items():
            self.set_property(k, v)
        for tmpl in self.SINK_TEMPLATES:
            if not tmpl.is_request:
                self._add_pad(tmpl, tmpl.name_template)
        for tmpl in self.SRC_TEMPLATES:
            if not tmpl.is_request:
                self._add_pad(tmpl, tmpl.name_template)

    # -- properties ---------------------------------------------------------
    def set_property(self, key: str, value: Any) -> None:
        key = key.replace("-", "_")
        key = self.PROP_ALIASES.get(key, key)
        if key == "name":
            self.name = str(value)
            return
        if key == "config_file":
            # reference: generic key=value property file, applied in file
            # order at the point the property is set (gst_tensor_parse_
            # config_file, nnstreamer_plugin_api_impl.c:1867; exposed by
            # tensor_decoder and tensor_filter, here by every element)
            self._apply_config_file(str(value))
            self.props["config_file"] = str(value)  # introspectable
            return
        if key not in self._prop_defs:
            raise ElementError(f"{self.describe()}: unknown property '{key}'")
        conv = self._prop_defs[key].convert
        self.props[key] = conv(value) if conv is not None else value

    def _apply_config_file(self, path: str) -> None:
        # cycle guard: a config file naming itself (or a pair naming each
        # other) must fail as an ElementError, not a RecursionError
        real = os.path.realpath(path)
        applying = getattr(self, "_config_files_applying", None)
        if applying is None:
            applying = self._config_files_applying = set()
        if real in applying:
            raise ElementError(
                f"{self.describe()}: config-file cycle via '{path}'")
        try:
            with open(path) as fh:
                lines = fh.read().splitlines()
        except OSError as e:
            raise ElementError(
                f"{self.describe()}: cannot read config-file '{path}': {e}")
        if not applying:  # top-level apply (not a nested config-file line)
            self._config_file_begin()
        applying.add(real)
        try:
            for ln in lines:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                key = ln.split("=", 1)[0].strip().replace("-", "_")
                key = self.PROP_ALIASES.get(key, key)
                if "=" in ln and (key in self._prop_defs
                                  or key in ("name", "config_file")):
                    k, v = ln.split("=", 1)
                    self.set_property(k.strip(), v.strip())
                else:
                    self._config_file_other_line(ln)
        finally:
            applying.discard(real)

    def _config_file_begin(self) -> None:
        """Hook: a fresh top-level config-file apply starts (subclasses
        reset any state accumulated from a previous apply)."""

    def _config_file_other_line(self, ln: str) -> None:
        """Hook for config-file lines that are not known properties.
        Default: unknown ``key=value`` is an error; anything else is
        ignored. tensor_filter overrides to merge into custom options."""
        if "=" in ln:
            self.set_property(*(p.strip() for p in ln.split("=", 1)))

    # elements hosting a subplugin registry set this to their
    # SubpluginKind; the reference's read-only ``sub-plugins`` property
    # (registered subplugin names) is then served here for all of them
    SUBPLUGIN_KIND = None

    def device_affinity(self) -> str:
        """Effective device affinity of THIS instance (classes whose
        affinity depends on configuration — e.g. tensor_src device=true —
        override; everyone else reports DEVICE_AFFINITY)."""
        return self.DEVICE_AFFINITY

    # -- fusion contract (runtime/fusion.py) --------------------------------
    def fusion_barrier(self) -> Optional[str]:
        """Why THIS instance cannot join a fused device segment, or None
        if it is a candidate. Subclasses with per-instance disqualifiers
        (tensor_filter sync-invoke/profiling) extend this."""
        if self.FUSION_BARRIER is not None:
            return self.FUSION_BARRIER
        aff = self.device_affinity()
        if aff != "device":
            return f"{aff}-affinity element"
        if not self.FUSABLE:
            return "FUSABLE=False (stateful element)"
        return None

    def fusion_stage(self):
        """Pure per-buffer transform for segment fusion: ``stage(tensors_
        tuple) -> tensors_tuple`` on tensors already on the segment's
        device, resolved AFTER caps negotiation. It must make no host
        transfer and no host sync, so that a CUDA graph can capture it.
        None = no stage right now (the segment falls back to per-element
        dispatch until the next invalidation)."""
        return None

    def fusion_device(self):
        """The device this member's stage must run on (a filter's
        backend device), or None when the stage follows its input."""
        return None

    def fusion_host_device(self):
        """Where this member, as a segment's first device-bound element,
        would move host inputs (a transform's ``accelerator``), or None."""
        return None

    def fusion_gate(self, buf: Buffer) -> bool:
        """Host-side per-buffer admission for fused dispatch (False =
        drop the buffer, e.g. QoS throttle). Only overrides are invoked —
        pure transform chains pay nothing."""
        return True

    def get_property(self, key: str) -> Any:
        key_n = key.replace("-", "_")
        if key_n == "sub_plugins" and self.SUBPLUGIN_KIND is not None:
            from ..registry.subplugin import names_csv

            return names_csv(self.SUBPLUGIN_KIND)
        return self.props[key_n]

    # -- pads ---------------------------------------------------------------
    def _add_pad(self, tmpl: PadTemplate, name: str) -> Pad:
        pad = Pad(self, tmpl, name)
        (self.sink_pads if tmpl.direction is PadDirection.SINK else self.src_pads).append(pad)
        return pad

    @property
    def sinkpad(self) -> Pad:
        return self.sink_pads[0]

    @property
    def srcpad(self) -> Pad:
        return self.src_pads[0]

    def get_pad(self, name: str) -> Optional[Pad]:
        for p in self.sink_pads + self.src_pads:
            if p.name == name:
                return p
        return None

    def request_pad(self, direction: PadDirection, name: Optional[str] = None) -> Pad:
        """Create an on-demand pad from a REQUEST template ("sink_%u" style)."""
        for tmpl in list(self.SINK_TEMPLATES) + list(self.SRC_TEMPLATES):
            if tmpl.direction is direction and tmpl.is_request:
                existing = self.sink_pads if direction is PadDirection.SINK else self.src_pads
                idx = len([p for p in existing if p.template is tmpl])
                pad_name = name or tmpl.name_template.replace("%u", str(idx))
                if self.get_pad(pad_name) is not None:
                    raise ElementError(f"{self.describe()}: pad {pad_name} exists")
                return self._add_pad(tmpl, pad_name)
        raise ElementError(f"{self.describe()}: no request template for {direction.value}")

    def get_compatible_pad(self, direction: PadDirection) -> Pad:
        """First unlinked pad in ``direction``, creating a request pad if needed."""
        pads = self.sink_pads if direction is PadDirection.SINK else self.src_pads
        for p in pads:
            if not p.is_linked:
                return p
        return self.request_pad(direction)

    def link(self, downstream: "Element") -> "Element":
        src = self.get_compatible_pad(PadDirection.SRC)
        sink = downstream.get_compatible_pad(PadDirection.SINK)
        src.link(sink)
        return downstream

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Transition to running; override to allocate resources."""

    def stop(self) -> None:
        """Transition to stopped; override to release resources."""

    def reset_flow(self) -> None:
        """Reset per-run stream state so the pipeline can replay after a
        stop(): EOS latches and negotiated caps are cleared (caps are
        re-announced by sources on the next start). Override to clear
        element-specific accumulation; always call super()."""
        with self._lock:
            self._eos_sent = False
        # restart safety: a replay must never dispatch through a fused
        # segment planned for the PREVIOUS run (play() re-installs fresh
        # segments after this reset — see runtime/fusion.py)
        self._fusion_head = None
        self._fusion_member = None
        for pad in self.sink_pads + self.src_pads:
            pad.got_eos = False
            pad.caps = None

    # -- latency ------------------------------------------------------------
    def report_latency(self):
        """This element's contribution (seconds) to the pipeline LATENCY
        query, or None if it adds none / doesn't report (reference:
        GST_QUERY_LATENCY handling — elements add their processing latency
        as the query travels upstream, tensor_filter.c:1386-1418)."""
        return None

    # -- messages -----------------------------------------------------------
    def post_message(self, msg_type: MessageType, **data) -> None:
        if self.pipeline is not None:
            self.pipeline.bus.post(Message(msg_type, self.name, data))

    def post_error(self, error: str) -> None:
        logger.error("%s: %s", self.describe(), error)
        self.post_message(MessageType.ERROR, error=error)
        if self.pipeline is not None:
            self.pipeline._element_error(self, error)

    # -- data flow ----------------------------------------------------------
    def _chain_guarded(self, pad: Pad, buf: Buffer) -> None:
        if not self.props["silent"]:
            logger.info(
                "%s: buffer on %s pts=%s tensors=%d",
                self.describe(), pad.name, buf.pts,
                getattr(buf, "num_tensors", len(buf.tensors)))
        try:
            # fused-segment head: the whole device chain runs as ONE
            # dispatch (runtime/fusion.py); a defused segment (a member
            # without a stage) returns False and the per-element path runs
            seg = self._fusion_head
            if seg is not None and seg.dispatch(pad, buf):
                return
            self.chain(pad, buf)
        except Exception as e:  # noqa: BLE001 - becomes a pipeline ERROR message
            logger.debug("%s", traceback.format_exc())
            self.post_error(f"{type(e).__name__}: {e}")

    def chain(self, pad: Pad, buf: Buffer) -> None:
        raise NotImplementedError(f"{self.describe()} cannot receive buffers")

    def push(self, buf: Buffer, pad: Optional[Pad] = None) -> None:
        (pad or self.srcpad).push(buf)

    # -- events & negotiation ----------------------------------------------
    def _handle_sink_event_guarded(self, pad: Pad, event: Event) -> None:
        try:
            self.handle_sink_event(pad, event)
        except Exception as e:  # noqa: BLE001
            logger.debug("%s", traceback.format_exc())
            self.post_error(f"{type(e).__name__}: {e}")

    def handle_sink_event(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.CAPS:
            caps: Caps = event.data["caps"]
            if not pad.template.caps.can_intersect(caps):
                raise ElementError(
                    f"caps {caps} not accepted on {pad.full_name} "
                    f"(template {pad.template.caps})"
                )
            pad.caps = caps
            self.set_caps(pad, caps)
            self.maybe_negotiate()
            # caps (re)negotiation reconfigures this element's transform:
            # a fused segment holding graphs captured against the OLD
            # caps must re-resolve on the next buffer
            seg = self._fusion_member
            if seg is not None:
                seg.invalidate()
        elif event.type is EventType.EOS:
            pad.got_eos = True
            if all(p.got_eos for p in self.sink_pads if p.is_linked):
                self.handle_eos()
        else:
            self.forward_event(event)

    def handle_eos(self) -> None:
        """All sink pads reached EOS. Default: flush + forward downstream."""
        self.send_eos()

    def send_eos(self) -> None:
        with self._lock:
            if self._eos_sent:
                return
            self._eos_sent = True
        for p in self.src_pads:
            p.push_event(Event.eos())

    def forward_event(self, event: Event) -> None:
        for p in self.src_pads:
            p.push_event(event)

    def handle_src_event(self, pad: Pad, event: Event) -> None:
        """Upstream event arriving on a src pad (e.g. QoS). Default: forward."""
        for p in self.sink_pads:
            p.send_upstream(event)

    # negotiation ------------------------------------------------------------
    def set_caps(self, pad: Pad, caps: Caps) -> None:
        """Input caps accepted; configure internal state. Override as needed."""

    def transform_caps(self, src_pad: Pad) -> Caps:
        """Compute this src pad's caps from negotiated sink caps.

        Default: passthrough of the first sink pad's caps (GstBaseTransform
        identity behavior). Called only when every linked sink pad has caps.
        """
        if self.sink_pads:
            return self.sink_pads[0].caps
        raise NotImplementedError(f"{self.describe()}: source must override transform_caps")

    def maybe_negotiate(self) -> None:
        """If all linked sink pads have caps, negotiate+announce src caps."""
        linked = [p for p in self.sink_pads if p.is_linked]
        if not linked or any(p.caps is None for p in linked):
            return
        self.negotiate_src()

    def negotiate_src(self) -> None:
        for pad in self.src_pads:
            if not pad.is_linked:
                continue
            out = self.transform_caps(pad)
            if out is None or out.is_empty:
                raise ElementError(f"{pad.full_name}: no output caps")
            peer_tmpl = pad.peer.template.caps
            out = out.intersect(peer_tmpl)
            if out.is_empty:
                raise ElementError(
                    f"{pad.full_name}: caps rejected by {pad.peer.full_name} "
                    f"(template {peer_tmpl})"
                )
            if not out.is_fixed:
                out = out.fixate()
            if pad.caps is not None and pad.caps == out:
                continue
            pad.push_event(Event.caps(out))

    def describe(self) -> str:
        return f"{self.ELEMENT_NAME or type(self).__name__}:{self.name}"

    def __repr__(self):
        return f"<{self.describe()}>"


class TransformElement(Element):
    """1-sink/1-src element transforming each buffer (GstBaseTransform)."""

    def chain(self, pad: Pad, buf: Buffer) -> None:
        out = self.transform(buf)
        if out is None:
            return  # dropped
        self.push(out)

    def transform(self, buf: Buffer) -> Optional[Buffer]:
        raise NotImplementedError


class SourceElement(Element):
    """Push source running its own task thread (GstBaseSrc + its task).

    Subclasses implement ``create() -> Buffer | None`` (None = EOS) and
    ``get_src_caps() -> Caps`` announced before the first buffer.
    """

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()

    def get_src_caps(self) -> Caps:
        raise NotImplementedError

    def create(self) -> Optional[Buffer]:
        raise NotImplementedError

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running.set()
        self._thread = threading.Thread(target=self._task, name=f"src:{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running.clear()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._running.is_set()

    def _task(self) -> None:
        try:
            caps = self.get_src_caps()
            if not caps.is_fixed:
                caps = caps.fixate()
            for pad in self.src_pads:
                if pad.is_linked:
                    pad.push_event(Event.caps(caps))
            while self._running.is_set():
                buf = self.create()
                if buf is None:
                    # EOS only on natural stream end; a stop() cancellation
                    # must not fake a clean completion on the bus.
                    if self._running.is_set():
                        self.send_eos()
                    return
                self.push(buf)
        except Exception as e:  # noqa: BLE001
            logger.debug("%s", traceback.format_exc())
            self.post_error(f"{type(e).__name__}: {e}")


class SinkElement(Element):
    """Terminal element (GstBaseSink): renders buffers, reports EOS."""

    def chain(self, pad: Pad, buf: Buffer) -> None:
        self.render(buf)

    def render(self, buf: Buffer) -> None:
        raise NotImplementedError

    def handle_eos(self) -> None:
        if self.pipeline is not None:
            self.pipeline._sink_reached_eos(self)
