"""Pipeline container, state machine, and message bus (L0' substrate).

Reference analog: GstPipeline + GstBus. States collapse to the useful subset
(NULL/PLAYING — the reference's READY/PAUSED exist to stage caps negotiation,
which in our design is event-driven and needs no separate state).
"""
from __future__ import annotations

import os
import queue as _queue
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Set

from ..analysis.sanitizer import named_lock, named_rlock
from ..core import Message, MessageType
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..utils import trace
from ..utils.log import logger
from ..utils.threads import ThreadRegistry
from .element import Element, SinkElement, SourceElement


class Bus:
    """Thread-safe out-of-band message stream from elements to the app."""

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()

    def post(self, msg: Message) -> None:
        self._q.put(msg)

    def pop(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def wait_for(self, types: Iterable[MessageType], timeout: float = 10.0) -> Optional[Message]:
        """Block until a message of one of ``types`` arrives (or timeout)."""
        types = set(types)
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            msg = self.pop(timeout=remaining)
            if msg is not None and msg.type in types:
                return msg


class Pipeline:
    """A runnable graph of elements."""

    def __init__(self, name: str = "pipeline", fuse: Optional[bool] = None,
                 place=None):
        self.name = name
        # device-segment fusion (runtime/fusion.py): ON by default — each
        # linear run of device elements becomes one dispatch per buffer
        # (a CUDA graph replay on the card). fuse=False (or the
        # NNS_NO_FUSE=1 escape hatch) keeps the per-element path.
        if fuse is None:
            fuse = os.environ.get("NNS_NO_FUSE", "") not in ("1", "true", "yes")
        self.fuse = bool(fuse)
        self._fused_segments: list = []  # set by fusion.install at play()
        # profile-guided placement (runtime/placement.py): OFF by default
        # — place="auto" plans the fused segments across the local cards
        # from the ProfileStore (calibrating on a miss) and tunes
        # inter-stage queue depths; a PlacementPlan instance applies a
        # serialized plan verbatim. NNS_NO_PLACE=1 is the kill switch
        # (wins over any constructor value).
        if os.environ.get("NNS_NO_PLACE", "") in ("1", "true", "yes"):
            place = None
        self.place = place
        self._placement_state = None  # set by placement.install at play()
        self.elements: Dict[str, Element] = {}
        self.bus = Bus()
        self._playing = False
        self._lock = named_lock("Pipeline._lock")
        self._eos_sinks: Set[str] = set()  # guarded-by: _lock
        # serializes play()/stop()/error-halt so a stale halt (spawned
        # for a run that a supervised restart has since replaced) can
        # never stop the NEW run's sources. Element threads must never
        # take this lock (play/stop join them while holding it) — the
        # error path only READS the epoch and spawns, it does not block.
        self._state_lock = named_rlock("Pipeline._state_lock")
        self._play_epoch = 0  # guarded-by: _state_lock
        # running-time anchor, set at each play() (GStreamer base_time
        # analog; mqttsink/mqttsrc stamp epochs against it)
        self.play_t0_mono: Optional[float] = None
        self._halt_threads = ThreadRegistry()
        # out-of-band state listeners: cb(kind, source, data) with kind in
        # {"playing", "stopped", "eos", "error"}. Unlike the Bus (a queue
        # one consumer drains), listeners fan out.
        self._state_listeners: List[Callable[[str, str, dict], None]] = []

    # -- construction -------------------------------------------------------
    def add(self, *elements: Element) -> "Pipeline":
        for el in elements:
            if el.name in self.elements:
                raise ValueError(f"duplicate element name '{el.name}'")
            self.elements[el.name] = el
            el.pipeline = self
        return self

    def get(self, name: str) -> Element:
        return self.elements[name]

    def link(self, *chain: Element) -> None:
        for up, down in zip(chain, chain[1:]):
            up.link(down)

    def add_state_listener(self, cb: Callable[[str, str, dict], None]) -> None:
        """Subscribe to out-of-band lifecycle notifications (see __init__).
        Listeners run on the notifying thread and must not block."""
        self._state_listeners.append(cb)

    def remove_state_listener(self, cb) -> None:
        if cb in self._state_listeners:
            self._state_listeners.remove(cb)

    def _notify_state(self, kind: str, source: str, data: dict) -> None:
        for cb in list(self._state_listeners):
            try:
                cb(kind, source, data)
            except Exception:  # noqa: BLE001 - a listener must not kill flow
                logger.exception("state listener failed for %s", kind)

    def element_stats(self) -> Dict[str, dict]:
        """Per-element runtime counters for every element exposing a
        ``.stats`` dict (queues: drop/level counters; tensor_fault:
        injection counters, tensor_filter: invoke statistics), plus one
        ``fused:<head>..<tail>`` pseudo-element per fused segment that
        dispatched or defused."""
        out: Dict[str, dict] = {}
        for el in self.elements.values():
            stats = getattr(el, "stats", None)
            if isinstance(stats, dict) and stats:
                out[el.name] = dict(stats)
            elif hasattr(stats, "snapshot"):  # InvokeStats (tensor_filter)
                out[el.name] = stats.snapshot()
        for seg in self._fused_segments:
            if seg.stats.get("dispatches") or seg.stats.get("defused"):
                out[f"fused:{seg.name}"] = dict(seg.stats)
        return out

    @property
    def fused_segments(self) -> list:
        """The FusedSegments installed by the last play() (empty when
        fuse=False or nothing fused)."""
        return list(self._fused_segments)

    @property
    def placement_plan(self):
        """The PlacementPlan applied by the last play() (None when
        placement is off or nothing planned)."""
        state = self._placement_state
        return state.plan if state is not None else None

    @property
    def sinks(self) -> List[SinkElement]:
        return [e for e in self.elements.values() if isinstance(e, SinkElement)]

    @property
    def sources(self) -> List[SourceElement]:
        return [e for e in self.elements.values() if isinstance(e, SourceElement)]

    # -- state --------------------------------------------------------------
    def play(self) -> "Pipeline":
        with self._state_lock:
            if self._playing:
                return self
            trace.install_from_env()   # NNS_TRACERS (GST_TRACERS analog)
            trace.dump_dot(self)       # NNS_DOT_DIR (GST_DEBUG_DUMP_DOT_DIR)
            self._validate_links()
            self._playing = True
            self._play_epoch += 1
            self.play_t0_mono = time.monotonic()
            with self._lock:
                self._eos_sinks.clear()
            for el in self.elements.values():
                el.reset_flow()
            # plan fused device segments AFTER flow reset (a restart must
            # never reuse the previous run's graphs) and BEFORE elements
            # start; graphs are captured lazily once caps have negotiated
            from . import fusion

            if self.fuse:
                fusion.install(self)
            else:
                fusion.uninstall(self)
            # placement AFTER fusion: the planner assigns the freshly
            # installed segments, re-planned from scratch on every play
            if self.place:
                from . import placement

                placement.install(self)
            elif self._placement_state is not None:
                from . import placement

                placement.uninstall(self)
            # memory accounting (obs/memory.py): queue-occupancy bytes
            # are read off live pipelines at scrape time
            obs_memory.track_pipeline(self)
            # start non-sources first so queues/filters are ready before
            # data flows
            for el in self.elements.values():
                if not isinstance(el, SourceElement):
                    el.start()
            for el in self.sources:
                el.start()
        # notify OUTSIDE the state lock: listeners take their own locks
        self.bus.post(Message(MessageType.STATE_CHANGED, self.name, {"state": "playing"}))
        self._notify_state("playing", self.name, {})
        return self

    def stop(self) -> "Pipeline":
        with self._state_lock:
            if not self._playing:
                return self
            self._playing = False
            for el in self.sources:
                el.stop()
            for el in self.elements.values():
                if not isinstance(el, SourceElement):
                    el.stop()
        # joined outside _state_lock — the halt threads acquire it
        self._halt_threads.drain(timeout_per=2.0)
        # explicit metrics unregister sweep: a stopped pipeline's
        # nns_fused_* / nns_placement_* / queue-bytes rows must leave the
        # scrape NOW, not whenever GC collects the weak refs (a replay
        # re-tracks at play())
        obs_metrics.untrack_pipeline(self)
        obs_memory.untrack_pipeline(self)
        if self._placement_state is not None:
            # an open calibration window must not outlive the run that
            # was feeding it samples (recording refcount balance)
            from . import placement

            placement.on_stop(self)
        if trace.ACTIVE:
            # env-activated chrome traces flush at every stop(), not only
            # at interpreter exit — a long-lived serve process produces
            # inspectable traces per run
            trace.flush_chrome_traces()
        self.bus.post(Message(MessageType.STATE_CHANGED, self.name, {"state": "stopped"}))
        self._notify_state("stopped", self.name, {})
        return self

    @property
    def playing(self) -> bool:
        return self._playing

    # -- LATENCY query -------------------------------------------------------
    def query_latency(self) -> dict:
        """Pipeline-wide latency answer (reference GST_QUERY_LATENCY as
        driven by tensor_filter's latency-report,
        tensor_filter.c:1386-1418): the query conceptually travels from
        each sink upstream, every element adding its ``report_latency()``
        contribution (tensor_filter pads its estimate with 5% headroom and
        remembers what it reported, so LATENCY bus messages only fire when
        the estimate escapes that headroom). Returns::

            {"latency_s": worst sink-to-source path total,
             "per_element": {name: contribution_s},   # reporting elements
             "per_sink": {sink_name: path_total_s}}
        """
        per_element: Dict[str, float] = {}
        memo: Dict[str, float] = {}

        def upstream(el: Element, on_path: frozenset) -> float:
            if el.name in memo:
                return memo[el.name]
            if el.name in on_path:
                return 0.0  # feedback loop (tensor_repo): cut the cycle
            own = el.report_latency()
            if own is not None:
                per_element[el.name] = own
            branches = [
                upstream(pad.peer.element, on_path | {el.name})
                for pad in el.sink_pads
                if pad.peer is not None and pad.peer.element is not None
            ]
            total = (own or 0.0) + (max(branches) if branches else 0.0)
            memo[el.name] = total
            return total

        per_sink = {s.name: upstream(s, frozenset()) for s in self.sinks}
        return {
            "latency_s": max(per_sink.values()) if per_sink else 0.0,
            "per_element": per_element,
            "per_sink": per_sink,
        }

    def _validate_links(self) -> None:
        for el in self.elements.values():
            for pad in el.sink_pads:
                if not pad.is_linked:
                    logger.warning("%s: unlinked sink pad %s", self.name, pad.full_name)

    # -- EOS / error flow ----------------------------------------------------
    def _element_error(self, element: Element, error: str = "") -> None:
        """Fatal element error: halt sources so the graph drains instead of
        spinning (GStreamer: apps stop the pipeline on a bus ERROR; we stop
        producing immediately, the app still owns final stop())."""
        if not self._playing:
            return
        # epoch-stamped + tracked (joined by stop()), not fire-and-forget.
        # The stamp closes a TOCTOU race: this thread can be descheduled
        # between the _playing check and the halt running, a restart
        # replaces the run meanwhile, and an unstamped halt would then
        # silently stop the NEW run's sources.
        t = threading.Thread(
            target=self._halt_sources, args=(self._play_epoch,),
            daemon=True, name=f"{self.name}:error-halt")
        t.start()
        self._halt_threads.track(t)
        self._notify_state("error", element.name,
                           {"element": element.name, "error": error})

    def _halt_sources(self, epoch: int) -> None:
        with self._state_lock:
            if epoch != self._play_epoch or not self._playing:
                return  # a restart replaced the run this halt belongs to
            for el in self.sources:
                try:
                    el.stop()
                except Exception:  # noqa: BLE001 - best-effort halt
                    logger.exception("error stopping %s", el.name)

    def _sink_reached_eos(self, sink: Element) -> None:
        with self._lock:
            self._eos_sinks.add(sink.name)
            done = len(self._eos_sinks) >= len(self.sinks)
        if done:
            self.bus.post(Message(MessageType.EOS, self.name, {}))
            self._notify_state("eos", self.name, {})

    def wait(self, timeout: float = 30.0) -> Message:
        """Run until EOS or ERROR; returns the terminating message."""
        msg = self.bus.wait_for((MessageType.EOS, MessageType.ERROR), timeout=timeout)
        if msg is None:
            raise TimeoutError(f"pipeline '{self.name}' did not reach EOS in {timeout}s")
        return msg

    def run(self, timeout: float = 30.0) -> Message:
        """play() + wait() + stop() convenience; raises on ERROR."""
        self.play()
        try:
            msg = self.wait(timeout=timeout)
        finally:
            self.stop()
        if msg.type is MessageType.ERROR:
            raise RuntimeError(f"pipeline error from {msg.source}: {msg.data.get('error')}")
        return msg

    # -- introspection -------------------------------------------------------
    def to_dot(self) -> str:
        """Graphviz dump (reference: GST_DEBUG_DUMP_DOT_DIR pipeline graphs)."""
        lines = [f'digraph "{self.name}" {{', "  rankdir=LR;"]
        for el in self.elements.values():
            lines.append(f'  "{el.name}" [shape=box,label="{el.describe()}"];')
        for el in self.elements.values():
            for pad in el.src_pads:
                if pad.is_linked:
                    caps = str(pad.caps) if pad.caps else ""
                    lines.append(
                        f'  "{el.name}" -> "{pad.peer.element.name}" [label="{caps}"];'
                    )
        lines.append("}")
        return "\n".join(lines)
