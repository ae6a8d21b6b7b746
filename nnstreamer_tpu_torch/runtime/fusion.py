"""Device-segment fusion (L0' substrate): CUDA-graph-captured segments.

The counterpart of nnstreamer_tpu's ``runtime/fusion.py``. Inline push
semantics charge every element hop a Python pad-hop plus — for device
elements — its own kernel launches per buffer. At ``Pipeline.play()``
every linear run of ``DEVICE_AFFINITY == "device"`` elements becomes a
**fused segment**: the per-element stages compose into one callable,
and a buffer entering the segment head costs one dispatch instead of N
chained chain()+launch hops.

On the card that one dispatch is **one CUDA graph per segment and input
signature** (shapes, dtypes, device): captured on the first buffer of
the signature — after a warm-up on a side stream, as PyTorch's CUDA-graph
recipe requires — and replayed for every buffer after it. A replay runs
the kernels eager mode runs, so fused and unfused runs give identical
bytes; ``torch.compile`` would re-fuse the elementwise work and promises
no such thing. On the CPU there is no graph: the stages compose into one
Python call, as nnstreamer_tpu's ``composed`` does.

The capture, on the card:
  * the device is a member's (the card a filter's backend opened on,
    where its weights live), else the placement planner's
    (``set_device``), else the card the inputs lie on, else the head
    transform's ``accelerator``. A re-plan never moves a filter's
    segment away from its weights: the planner's pin reaches the filter
    when its backend next opens;
  * host inputs reach the card through the segment's pinned two-slot
    stager (``transport/staging.py``): frame N+1's copy runs on a side
    stream while frame N's replay computes, where a pageable copy would
    first wait for that replay and block the host (``chip_smoke.py``
    phase 13d measures both). The stager hands a frame under
    ``STAGE_MIN_BYTES`` back on the host, and the replay copies it
    straight into the graph's static input (from pageable memory, which
    CUDA stages on the host at once): there is no copy to overlap, and
    the stager's own calls (a side stream, an event, a pinned slot) cost
    more than the copy (``tools/microbench_overhead_torch.py
    --stage-sweep`` measures both paths over frame sizes);
  * the fence of the last replay is one CUDA event a segment and card,
    recorded again at every replay on that card and handed out (then
    made anew) by ``invalidate``;
  * ``capture_error_mode="thread_local"``: sources, queues and decoders
    keep launching on the same card from their threads while one thread
    captures; the default ``"global"`` mode would make their calls
    illegal;
  * each input is copied into the graph's static input before
    ``replay()``, and each output is **cloned out of the graph's pool**
    before it is pushed: the next replay rewrites the pool, and a
    ``queue`` or a ``tensor_sink max-stored=`` may still hold the
    previous output;
  * graphs are kept per signature, at most ``MAX_GRAPHS`` (least
    recently used dropped); each capture counts in ``stats["retraces"]``
    (on the CPU, each new signature of a build does);
  * a capture that fails raises, and the head's error path posts a bus
    ERROR. Nothing falls back to eager dispatch. The one defuse is
    nnstreamer_tpu's own: a member whose ``fusion_stage()`` is None (a
    filter pinned with ``custom=device:N`` to another card, or whose
    model is not declared safe to capture) makes the per-element path
    serve until the next invalidation.

What a capture fixes: host values a stage reads while it is captured
become constants of the graph, and a host sync inside it is an error.
So on the card a filter joins a segment only when its model declares
itself safe to capture (``capture_safe = True`` on the callable: the
port's zoo entries and its builtins but ``sleeper``); any other model
hands out no stage and the segment defuses, as for a pinned filter. The
LM filter declares nothing: its decode loop reads host positions
(``ops/decode_attention.py::_pos_tensor``), keys its per-stream row
counters by the current stream (the capture stream, under capture), and
the hand kernels' launch counters would count the capture, not the
replays. On the CPU nothing is captured and every model fuses, as in
nnstreamer_tpu.

Segments break (a **fusion barrier**) at host/neutral-affinity elements
(decoders, converters, queues, tees), at queue boundaries, at fan-in or
fan-out, at ``FUSABLE = False`` elements (``tensor_serving``) and at
per-instance disqualifiers (``Element.fusion_barrier()``: tensor_filter
sync-invoke or latency profiling).

Cache invalidation: a CAPS event reaching any member invalidates its
segment (re-captured on the next buffer), as does ``reset_flow()`` on
restart (``Pipeline.play()`` re-plans from scratch, so a supervised
restart never replays a stale graph) and a hot model swap
(``tensor_filter.commit_model``/``reload_model`` through
``_invalidate_fused``). A graph holds the device addresses of the
weights it was captured with, so a swap must not free the old weights
while a replay that reads them may still run: every dispatch resolves
its callable and enqueues its replay under the segment's run lock and
records a CUDA event (the **fence**) behind the replay; ``invalidate()``
drops the graphs, waits for a dispatch in progress to finish enqueuing,
and returns the fence of the last replay, which the swap waits on before
it releases the old backend. Escape hatches: ``Pipeline(fuse=False)`` or
``NNS_NO_FUSE=1``.

Donation: nnstreamer_tpu donates a segment's input arrays to XLA when
every upstream element is a single-owner producer
(``_DONATION_SAFE_CHAIN``). The port keeps the topology rule, so both
packages agree on which segments may donate (``FusedSegment._donate``),
but in the port it decides nothing: a capture reads its inputs through
the graph's own static copies, there is no XLA buffer to alias, and the
incoming frame stays intact because the pad-hop taps
(``obs/quality.py``) still read it after the push returns. The frame is
freed when its last holder drops it, as unfused.

The AOT compile cache (``aot/``, on when ``NNS_AOT_CACHE`` names a
directory): at the first buffer of a build the segment loads its
exported program from the cache (``stats["aot_hits"]``) or exports the
composed stages and saves them (``stats["aot_exports"]``), then serves
through that program's module — on the card the CUDA graph captures the
module as it would the live stages. A stage that does not export serves
live, logged and counted in ``stats["aot_refused"]``. A segment pinned
to a card by the placement planner does not consult the cache (its
program must run where the plan put it). ``invalidate(evict_aot=True)``
(a model swap) evicts the retiring generation's artifact.
"""
from __future__ import annotations

import gc
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

import torch

from ..analysis.sanitizer import named_lock, named_rlock
from ..core import Buffer, clock_now
from ..core.buffer import as_torch
from ..obs import context as obs_context
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..obs import quality as obs_quality
from ..utils import trace
from ..utils.log import logger
from .element import Element

if TYPE_CHECKING:
    from .pipeline import Pipeline


# donation safety is TRANSITIVE: a stage can pass a tensor through
# unmodified (identity models, typecast to the same dtype, apply= skips,
# output-combination i<N> passthrough), so a tensor entering the segment
# may really be owned arbitrarily far upstream. Donation is therefore
# allowed only when EVERY transitive upstream element is in this
# allowlist (fresh per-frame producers and pure single-consumer movers)
# and has a single linked src pad — anything that shares (tee),
# retains (aggregator), duplicates (fault) or lets the application keep
# a reference (appsrc) disqualifies.
_DONATION_SAFE_CHAIN = ("tensor_src", "capsfilter", "queue",
                        "tensor_transform", "tensor_filter")

#: captured graphs kept per segment, one per input signature
MAX_GRAPHS = 8

#: host frames of at least this many bytes ride the pinned stager; the
#: stager hands a smaller one back for the replay to copy. On an H100
#: (``tools/microbench_overhead_torch.py --stage-sweep``, a 2-element
#: chain) the replay's copy was the cheaper path up to 4 MiB frames and
#: the stager from 16 MiB; with a MobileNet-v2 replay behind it
#: (``chip_smoke.py`` phase 13d) the stager also won at 9.6 MB batches
#: and lost at 150 KB frames
STAGE_MIN_BYTES = 8 << 20

#: eager runs on a side stream before a capture (lazy cuDNN/cuBLAS
#: handles, workspaces and a builtin's weights are made there, not in
#: the graph)
WARMUP_RUNS = 3

# the side stream of the warm-up runs and the capture stream, made once
# a card and shared by every segment's capture under _CAPTURE_LOCK (a
# stream holds one capture at a time). cuBLAS keeps a workspace per
# (handle, stream) for the life of the process (33 MiB a stream on an
# H100), so streams made for each capture would leave two more
# workspaces on the card at every re-capture (a hot swap, a restart).
_CAPTURE_LOCK = named_lock("fusion._CAPTURE_LOCK")
_CAPTURE_STREAMS: Dict[torch.device, tuple] = {}  # guarded-by: _CAPTURE_LOCK


def barrier_reason(el: "Element") -> Optional[str]:
    """Why ``el`` cannot join a fused segment (None = fusable candidate).

    Combines the element's own contract (``fusion_barrier()``: affinity,
    FUSABLE flag, per-instance disqualifiers) with the structural
    requirement of a linear chain: exactly one linked sink pad and one
    linked src pad (tee fan-out and in-use request pads fail this)."""
    reason = el.fusion_barrier()
    if reason is not None:
        return reason
    linked_sinks = [p for p in el.sink_pads if p.is_linked]
    linked_srcs = [p for p in el.src_pads if p.is_linked]
    if (len(el.sink_pads) != 1 or len(el.src_pads) != 1
            or len(linked_sinks) != 1 or len(linked_srcs) != 1):
        return ("fan-in/fan-out (a fused segment needs exactly one linked "
                "sink and one linked src pad)")
    return None


@dataclass
class SegmentPlan:
    """Result of :func:`plan_segments`: the fusable runs and, for every
    non-member, why it broke a chain."""

    segments: List[List["Element"]] = field(default_factory=list)
    barriers: Dict[str, str] = field(default_factory=dict)

    def describe(self) -> str:
        lines = []
        for seg in self.segments:
            lines.append(" -> ".join(el.name for el in seg))
        return "; ".join(lines) if lines else "(no fused segments)"


def plan_segments(pipeline: "Pipeline", min_run: int = 2) -> SegmentPlan:
    """Partition the graph into maximal linear runs of fusable device
    elements. Pure topology — nothing is captured, no backend is touched.
    Runs shorter than ``min_run`` elements are not segments — the default
    2 because a single dispatch is already a single dispatch; the
    placement planner (runtime/placement.py) passes 1, since a lone
    device element between queues is still a pipeline *stage* that needs
    a card."""
    plan = SegmentPlan()
    members: Dict[int, bool] = {}
    for el in pipeline.elements.values():
        reason = barrier_reason(el)
        if reason is not None:
            plan.barriers[el.name] = reason
        else:
            members[id(el)] = True

    def next_member(el: "Element") -> Optional["Element"]:
        for pad in el.src_pads:
            if pad.peer is not None:
                nxt = pad.peer.element
                return nxt if id(nxt) in members else None
        return None

    def prev_member(el: "Element") -> Optional["Element"]:
        for pad in el.sink_pads:
            if pad.peer is not None:
                prv = pad.peer.element
                return prv if id(prv) in members else None
        return None

    visited: set = set()
    for el in pipeline.elements.values():
        if id(el) not in members or id(el) in visited:
            continue
        # rewind to the head of this run (bounded to the member count so a
        # pure-device cycle cannot spin the rewind; the cycle itself is
        # rejected after the forward walk below)
        head = el
        hops = 0
        while hops <= len(members):
            prv = prev_member(head)
            if prv is None or id(prv) in visited or prv is el:
                break
            head = prv
            hops += 1
        seg: List["Element"] = []
        cur: Optional["Element"] = head
        while cur is not None and id(cur) in members and id(cur) not in visited:
            visited.add(id(cur))
            seg.append(cur)
            cur = next_member(cur)
        # a pure-device ring linearizes to a run whose tail feeds a
        # member again: REJECT it — a fused tail pushing back into its
        # own head would recurse unboundedly
        if cur is not None and any(cur is m for m in seg):
            plan.barriers[seg[0].name] = "device-element cycle (not fusable)"
            continue
        if len(seg) >= min_run:
            plan.segments.append(seg)
    return plan


def _donation_safe(head: "Element") -> bool:
    """Whether the segment may drop its inputs as soon as they are copied
    in. Requires a direct device-affinity producer AND a fully
    single-owner upstream closure (see _DONATION_SAFE_CHAIN)."""
    producer = None
    for pad in head.sink_pads:
        if pad.peer is not None:
            producer = pad.peer.element
    if producer is None or producer.device_affinity() != "device":
        return False
    seen = set()
    stack = [producer]
    while stack:
        el = stack.pop()
        if id(el) in seen:
            continue
        seen.add(id(el))
        if el.ELEMENT_NAME not in _DONATION_SAFE_CHAIN:
            return False
        if sum(1 for p in el.src_pads if p.is_linked) != 1:
            return False
        for pad in el.sink_pads:
            if pad.peer is not None:
                stack.append(pad.peer.element)
    return True


class _Graph:
    """One capture: the graph, its static inputs and outputs, and the
    bytes its private pool took."""

    __slots__ = ("graph", "static_in", "static_out", "pool_bytes")

    def __init__(self, graph, static_in, static_out, pool_bytes: int):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.pool_bytes = pool_bytes


def _norm(device) -> Optional[torch.device]:
    """``device`` as a torch.device with its index (``cuda`` = the
    current card)."""
    if device is None:
        return None
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _reset_rng_capture(dev: torch.device) -> None:
    """A capture whose end failed never ran its generators' capture
    epilogue: the card's default generator then believes a capture is
    underway, and every later random op on that card raises ("Offset
    increment outside graph capture"). Give the generator a fresh state
    with the same seed and offset."""
    gen = torch.cuda.default_generators[dev.index]
    try:
        gen.graphsafe_set_state(gen.clone_state())
    except (AttributeError, RuntimeError):  # a torch without graph-safe states
        pass


class FusedSegment:
    """One linear run of device elements run as a single dispatch.

    The head element's ``_chain_guarded`` routes buffers here; interior
    elements keep their pads, caps negotiation and event flow untouched
    (CAPS/EOS travel element-to-element exactly as unfused), only the
    per-buffer data path collapses. ``dispatch`` returns False when the
    segment is defused (a member has no stage): the caller then chains
    per-element until the next ``invalidate()``.
    """

    # sampled device-latency probe cadence: one CUDA-event sync every N
    # dispatches keeps the per-segment latency estimate honest without
    # serializing the stream
    PROBE_EVERY = 16

    def __init__(self, elements: List["Element"]):
        self.elements = list(elements)
        self.head = elements[0]
        self.tail = elements[-1]
        self.name = f"{self.head.name}..{self.tail.name}"
        # profiler series key: pipeline-prefixed + canonical member
        # names, so restarts/replicas of one launch line share an entry
        pipe = getattr(self.head, "pipeline", None)
        self._profile_key = (
            f"{pipe.name if pipe is not None else '?'}:"
            f"{obs_profile.canonical_base(self.head)}.."
            f"{obs_profile.canonical_base(self.tail)}")
        self._lock = named_lock(f"FusedSegment._lock:{self.name}")
        # held from resolving the callable to the fence record of one
        # dispatch; invalidate() takes it to drain a dispatch in progress
        # (always taken BEFORE _lock, never while holding it)
        self._run_lock = named_rlock(f"FusedSegment._run_lock:{self.name}")
        # CUDA event recorded behind the latest replay (None on the CPU
        # and before the first replay), on the card of _fence_home; made
        # anew when the segment replays on another card
        self._fence: Optional[torch.cuda.Event] = None  # guarded-by: _run_lock
        self._fence_home: Optional[torch.device] = None  # guarded-by: _run_lock
        self._gen = 0            # guarded-by: _lock
        self._call: Optional[Callable] = None   # guarded-by: _lock (reads racy-ok)
        self._defused = False    # guarded-by: _lock (reads racy-ok)
        # the placement planner's device (set_device); a member's own
        # device (a filter's backend card) wins over it at build
        self._device: Optional[torch.device] = None  # guarded-by: _lock
        self._home: Optional[torch.device] = None    # guarded-by: _lock
        self._host_home: Optional[torch.device] = None  # guarded-by: _lock
        # captured graphs by input signature (the card) and signatures
        # seen by this build (the CPU)
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()  # guarded-by: _lock
        self._seen: set = set()  # guarded-by: _lock
        # pinned double-buffered host→device staging
        # (transport/staging.py), built on the first dispatch on a card
        # that sees host inputs; it follows the segment's device
        self._stager = None      # guarded-by: _lock (reads racy-ok)
        # calibration hook: placement installs a per-dispatch probe while
        # a calibration window is open (consulted under obs_profile.ACTIVE)
        self._placement_probe: Optional[Callable] = None
        # memory accounting (obs/memory.py): armed per build generation,
        # consumed by the first dispatch while accounting is on
        self._mem_pending = False  # guarded-by: _lock (reads racy-ok)
        # host-side per-buffer gates (QoS throttle on member filters);
        # empty for pure transform chains
        self._gates = [
            el.fusion_gate for el in elements
            if type(el).fusion_gate is not Element.fusion_gate
        ]
        self._donate = _donation_safe(self.head)
        # AOT compile cache (aot/): whether the current build still has
        # to consult it (at its first dispatch, which has the example
        # inputs), and the (cache, key, stage, digest) of the artifact
        # it serves, which invalidate(evict_aot=True) evicts
        self._aot_pending = False  # guarded-by: _lock (reads racy-ok)
        self._aot_built = None   # guarded-by: _lock
        self.stats = {
            "elements": len(self.elements),
            "dispatches": 0,
            "retraces": 0,
            "defused": 0,
            "aot_hits": 0,
            "aot_exports": 0,
            "aot_refused": 0,
            "total_s": 0.0,
            "probe_device_s": 0.0,
        }

    # -- cache control -------------------------------------------------------
    def invalidate(self, evict_aot: bool = False
                   ) -> Optional[torch.cuda.Event]:
        """Drop the composed callable and every captured graph: caps
        renegotiation, hot model swaps and restarts call this so the next
        buffer re-resolves against current state. Also re-arms a defused
        segment. Returns the fence: the CUDA event recorded behind the
        last replay of the dropped graphs, after any dispatch in progress
        has finished enqueuing (None when nothing was replayed on a
        card). A model swap waits on it before it frees the old weights.
        ``evict_aot=True`` (the model-swap path) also evicts the retiring
        generation's AOT artifact: the old model's program leaves disk
        with its backend. Caps events and placement changes keep it for
        the restart and replica warm paths (the rebuild re-keys anyway)."""
        with self._lock:
            self._gen += 1
            self._call = None
            self._defused = False
            self._aot_pending = False
            self._graphs = OrderedDict()
            self._seen = set()
            built = self._aot_built
            if evict_aot:
                self._aot_built = None
        if evict_aot and built is not None:
            cache, key, stage, digest = built
            try:
                cache.evict(key, stage, digest)
            except OSError:  # a shared cache dir raced us; eviction is GC
                pass
        with self._run_lock:
            fence, self._fence = self._fence, None
        # the same events invalidate the placement decision (caps change
        # tensor sizes, a hot swap changes the model's cost)
        pipe = getattr(self.head, "pipeline", None)
        state = getattr(pipe, "_placement_state", None)
        if state is not None:
            state.mark_dirty()
        return fence

    def set_device(self, device) -> None:
        """Pin this segment's dispatch to ``device`` (placement planner).
        A change drops the graphs — the next buffer captures on the new
        card, unless a member holds a device of its own (a filter's
        backend card), which wins at the rebuild."""
        device = _norm(device)
        with self._lock:
            if device == self._device:
                return
            self._device = device
            self._gen += 1
            self._call = None
            self._defused = False
            self._graphs = OrderedDict()
            self._seen = set()

    @property
    def device(self) -> Optional[torch.device]:
        """The planner-assigned device (None = not placed)."""
        return self._device

    def _stage(self, tensors, home: torch.device):
        """Host→device staging onto ``home`` (see _inputs); the stager's
        slots follow the segment when its device changes."""
        from ..transport.staging import DoubleBufferedStager

        s = self._stager
        if s is None or s.device != home:
            with self._lock:
                s = self._stager
                if s is None:
                    s = self._stager = DoubleBufferedStager(
                        home, min_bytes=STAGE_MIN_BYTES)
                elif s.device != home:
                    s.retarget(home)
        return s.stage(tensors)

    def _build(self) -> Optional[Callable]:
        # a dirty placement plan (caps event / hot swap marked it) is
        # re-resolved HERE, on the rebuild path — never per buffer
        pipe = getattr(self.head, "pipeline", None)
        state = getattr(pipe, "_placement_state", None)
        if state is not None:
            state.refresh_if_dirty()
        with self._lock:
            gen = self._gen
            device = self._device
        stages = []
        for el in self.elements:
            stage = el.fusion_stage()
            if stage is None:
                with self._lock:
                    if self._gen == gen:
                        self._defused = True
                        self.stats["defused"] += 1
                logger.info(
                    "fused segment %s: %s has no stage — falling back to "
                    "per-element dispatch", self.name, el.describe())
                return None
            stages.append(stage)

        def composed(xs):
            for stage in stages:
                xs = stage(xs)
            return tuple(xs)

        # a member's device first: a filter's weights live on the card
        # its backend opened on, whatever a re-plan pinned since
        home = next((d for d in (el.fusion_device()
                                 for el in self.elements)
                     if d is not None), device)
        host_home = next((d for d in (el.fusion_host_device()
                                      for el in self.elements)
                          if d is not None), None)
        # publish only if no invalidation raced the build
        with self._lock:
            if self._gen == gen and not self._defused and self._call is None:
                self._call = composed
                self._home = _norm(home)
                self._host_home = _norm(host_home)
                self._mem_pending = True
                self._aot_pending = device is None
        return composed

    def _caps_key(self) -> str:
        """The caps into the head and out of the tail, as negotiated
        before the first buffer reaches the segment."""
        def caps(pads):
            return ";".join(str(p.caps) for p in pads if p.caps is not None)
        return f"{caps(self.head.sink_pads)}->{caps(self.tail.src_pads)}"

    def _aot_resolve(self, composed: Callable, args: list) -> Callable:
        """AOT compile-cache consult at a build's first dispatch: load
        this segment's exported program, or export the composed stages
        and save them; either way the segment then serves THROUGH the
        program (the exporting process runs the graph a warm restart
        loads). Returns ``composed`` when the cache is off or the stages
        do not export."""
        from .. import aot

        with self._lock:
            gen = self._gen
            pending, self._aot_pending = self._aot_pending, False
        cache = aot.default_cache() if pending else None
        pipe = getattr(self.head, "pipeline", None)
        if cache is None or pipe is None:
            return composed
        try:
            # the key's caps are the segment's own: the pipeline's sink
            # may not have negotiated yet at the first dispatch (a queue
            # between them hands the CAPS event on from its own thread),
            # and a key read then would differ from a restart's
            key = dict(aot.pipeline_key(pipe), caps=self._caps_key())
            stage, digest = aot.segment_identity(self.elements)
            example = (tuple(args),)
            loaded = cache.load(key, stage, digest)
            if loaded is not None and loaded.compatible(example):
                self.stats["aot_hits"] += 1
            else:
                try:
                    blob, meta, loaded = aot.export_stage(composed, example)
                except aot.ExportError as e:
                    self.stats["aot_refused"] += 1
                    logger.info("fused segment %s: AOT export failed (%s) "
                                "— serving live", self.name, e)
                    return composed
                cache.save(key, stage, digest, blob, meta)
                self.stats["aot_exports"] += 1
                logger.info("fused segment %s: exported %s AOT artifact "
                            "(%d bytes) for stage %s", self.name,
                            "shape-poly" if meta["poly"] else "static",
                            meta["nbytes"], stage)
            served = aot.guarded(loaded, composed)
        except Exception:  # noqa: BLE001 - cache trouble != data loss
            self.stats["aot_refused"] += 1
            logger.exception("fused segment %s: AOT cache consult failed "
                             "— serving live", self.name)
            return composed
        with self._lock:
            if self._gen == gen and self._call is composed:
                self._call = served
                self._aot_built = (cache, key, stage, digest)
                return served
        return composed

    # -- the device side ----------------------------------------------------
    def _resolve_home(self, args) -> torch.device:
        home = self._home
        if home is not None:
            return home
        for t in args:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                return t.device
        return self._host_home or torch.device("cpu")

    def _inputs(self, tensors, home: torch.device) -> list:
        """The buffer's tensors as the stages take them: on ``home``. On
        a card, host inputs go through the pinned stager (its copy
        overlaps the previous replay; a pageable copy would block the
        host until the card caught up), which hands a frame under
        ``STAGE_MIN_BYTES`` back on the host for the replay to copy."""
        if home.type == "cuda" and any(
                not (isinstance(t, torch.Tensor) and t.is_cuda)
                for t in tensors):
            return self._stage(tensors, home)
        out = []
        for t in tensors:
            t = as_torch(t)
            if home.type != "cuda":
                t = t.to(home)
            elif t.device != home:
                # the cross-card hop of a placed segment (nnstreamer_tpu's
                # in_shardings reshard)
                t = t.to(home, non_blocking=True)
            out.append(t)
        return out

    def _capture(self, call: Callable, args: list,
                 home: torch.device) -> _Graph:
        """Warm up on a side stream, then capture ``call`` on static
        copies of ``args`` (thread-local capture mode), on the card's
        pair of capture streams (``_CAPTURE_STREAMS``)."""
        static_in = []
        for a in args:
            s = torch.empty(a.shape, dtype=a.dtype, device=home)
            s.copy_(a)
            static_in.append(s)
        xs = tuple(static_in)
        with _CAPTURE_LOCK:
            if home not in _CAPTURE_STREAMS:
                _CAPTURE_STREAMS[home] = (torch.cuda.Stream(home),
                                          torch.cuda.Stream(home))
            side, cap = _CAPTURE_STREAMS[home]
            cur = torch.cuda.current_stream(home)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    call(xs)
            cur.wait_stream(side)
            # nnlint: disable=NNL203 — the warm-up on the side stream must end
            # before the capture begins; captures on a card are serialized by
            # this lock by design
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            before = torch.cuda.memory_reserved(home)
            cap.wait_stream(cur)
            # a garbage collection on this thread during the capture could
            # destroy an unreachable segment's graph, which the capture
            # forbids (the capture then fails): none runs until it ends
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(cap):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outs = call(xs)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except Exception:  # noqa: BLE001 - the first error is the news
                            pass
                        _reset_rng_capture(home)
                        raise
                    graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            cur.wait_stream(cap)
            pool = max(0, torch.cuda.memory_reserved(home) - before)
            return _Graph(graph, static_in, tuple(outs), pool)

    def _replay(self, call: Callable, args: list, home: torch.device):
        sig = (home,) + tuple((tuple(a.shape), a.dtype) for a in args)
        with self._lock:
            g = self._graphs.get(sig)
            if g is not None:
                self._graphs.move_to_end(sig)
        if g is None:
            g = self._capture(call, args, home)
            with self._lock:
                self.stats["retraces"] += 1
                # kept only while ``call`` is still the published callable:
                # an invalidation (a swap) may have run since this dispatch
                # took it, and a graph of the old stages kept under the
                # new build would replay the old weights after their
                # release
                if self._call is call:
                    self._graphs[sig] = g
                    while len(self._graphs) > MAX_GRAPHS:
                        self._graphs.popitem(last=False)
        for s, a in zip(g.static_in, args):
            s.copy_(a, non_blocking=True)
        g.graph.replay()
        # the next replay rewrites the pool: hand downstream its own copy
        outs = tuple(o.clone() for o in g.static_out)
        fence = self._fence
        if fence is None or self._fence_home != home:
            # an event records on its own card only: a segment the
            # planner moved (set_device) fences on its new card
            fence = self._fence = torch.cuda.Event()
            self._fence_home = home
        fence.record()
        return outs, g

    def _run(self, call: Callable, args: list, home: torch.device):
        if home.type != "cuda":
            sig = tuple((tuple(a.shape), a.dtype) for a in args)
            with self._lock:
                if sig not in self._seen:
                    self._seen.add(sig)
                    self.stats["retraces"] += 1
            return call(tuple(args)), None
        if torch.cuda.current_device() != home.index:
            with torch.cuda.device(home):
                return self._replay(call, args, home)
        return self._replay(call, args, home)

    def _record_memory(self, g: Optional[_Graph]) -> None:
        """One-shot per build (memory accounting on): the bytes the
        graph's private pool took across its capture (temp), the
        segment's outputs and inputs, beside the members' parameters."""
        params = 0
        for el in self.elements:
            backend = getattr(el, "backend", None)
            if backend is not None:
                params += obs_memory.backend_param_nbytes(backend)
        fields = {"param_bytes": params}
        if g is not None:
            fields.update(temp_bytes=g.pool_bytes,
                          output_bytes=_nbytes(g.static_out),
                          argument_bytes=_nbytes(g.static_in))
        obs_memory.record_stage(self._profile_key, "fused", **fields)

    # -- hot path ------------------------------------------------------------
    def dispatch(self, pad, buf: Buffer) -> bool:
        """Run the whole segment as one dispatch (a graph replay on the
        card) and push the result from the tail's src pad. Returns False
        when defused (the caller chains per-element instead)."""
        with self._run_lock:
            call = self._call
            if call is None:
                if self._defused:
                    return False
                call = self._build()
                if call is None:
                    return False
            for gate in self._gates:
                if not gate(buf):
                    return True  # dropped (QoS throttle), buffer consumed
            home = self._resolve_home(buf.tensors)
            args = self._inputs(buf.tensors, home)
            if self._aot_pending:
                call = self._aot_resolve(call, [a.to(home) for a in args])
            t0 = clock_now()
            try:
                outs, g = self._run(call, args, home)
            except Exception as e:
                # an allocation failure must land in the flight ring WITH
                # the owning stage's name before the error path erases
                # the context
                if obs_memory.looks_like_oom(e):
                    pipe = getattr(self.head, "pipeline", None)
                    obs_memory.record_alloc_failure(
                        self._profile_key, e,
                        pipeline=pipe.name if pipe is not None else None)
                raise
            del call
        # total_s gets ONLY the host-side dispatch time, even on probed
        # frames (device completion goes to probe_device_s)
        dt = clock_now() - t0
        if obs_memory.ACTIVE and self._mem_pending:
            with self._lock:  # once per build, never steady state
                pending = self._mem_pending
                self._mem_pending = False
            if pending:
                self._record_memory(g)
        st = self.stats
        st["dispatches"] += 1
        st["total_s"] += dt
        if obs_quality.ACTIVE and \
                st["dispatches"] % obs_quality.SAMPLE_EVERY == 0:
            # data-plane health tap (obs/quality.py): one device reduce
            # per sampled output tensor, without defusing
            obs_quality.record_fused_outputs(self._profile_key, outs)
        probed = st["dispatches"] % self.PROBE_EVERY == 0
        if probed:
            if home.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(home))
                # nnlint: disable=NNL101 — sampled latency probe: one
                # sync every PROBE_EVERY dispatches, by contract
                done.synchronize()
            st["probe_device_s"] = clock_now() - t0
        if obs_profile.ACTIVE:
            # continuous profiler: per-segment host dispatch time every
            # buffer, device-complete latency on probed frames
            obs_profile.record_fused(
                self._profile_key, dt,
                device_s=st["probe_device_s"] if probed else None)
            # placement calibration (runtime/placement.py)
            cb = self._placement_probe
            if cb is not None:
                cb(self)
        if trace.ACTIVE:
            trace.notify_fused(self.name, t0, dt,
                               {"elements": len(self.elements)})
        if obs_context.TRACING:
            parent = buf.meta.get("trace")
            if parent is not None:
                # the request's span context rode in on the buffer meta:
                # the one-dispatch chain becomes a child span of it
                obs_context.record_span(
                    f"fused:{self.name}", kind="fused", parent=parent,
                    start_s=t0, dur_s=dt,
                    attrs={"elements": len(self.elements)})
        out = Buffer(list(outs)).copy_metadata_from(buf)
        self.tail.push(out)
        return True

    def teardown(self) -> None:
        """Release what the segment holds beyond a rebuild: the pinned
        staging slots (the graphs go with ``invalidate``). The stager
        object stays, with its counters, and stages again on the next
        dispatch."""
        stager = self._stager
        if stager is not None:
            stager.drain()

    def __repr__(self):
        return f"FusedSegment<{self.name} n={len(self.elements)}>"


def install(pipeline: "Pipeline") -> SegmentPlan:
    """Plan and annotate: called from ``Pipeline.play()`` after flow reset,
    before elements start. Idempotent — a replay re-plans from scratch."""
    uninstall(pipeline)
    plan = plan_segments(pipeline)
    segments: List[FusedSegment] = []
    for elements in plan.segments:
        seg = FusedSegment(elements)
        for el in elements:
            el._fusion_member = seg
        elements[0]._fusion_head = seg
        segments.append(seg)
    pipeline._fused_segments = segments
    if segments:
        # fused pipelines join the metrics plane: each segment's
        # dispatch/retrace/defuse counters render at GET /metrics
        obs_metrics.track_pipeline(pipeline)
        logger.info("pipeline %s: fused %d device segment(s): %s",
                    pipeline.name, len(segments), plan.describe())
    return plan


def uninstall(pipeline: "Pipeline") -> None:
    """Clear every fusion annotation (``fuse=False`` replays, teardown)
    and release each segment's staging slots."""
    for seg in getattr(pipeline, "_fused_segments", ()):
        seg.teardown()
    for el in pipeline.elements.values():
        el._fusion_member = None
        el._fusion_head = None
    pipeline._fused_segments = []
