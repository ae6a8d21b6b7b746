"""Stream sharding: scatter a live tensor stream across N branches and
re-join it in order (L3) — the counterpart of nnstreamer_tpu's
``elements/shard.py``.

Reference analog: the closest the reference offers for data-parallel
offload is ``tee`` + N ``tensor_query_client`` branches (SURVEY.md §2.9 DP
row) — every branch sees EVERY frame, and nothing restores order. These two
elements provide the real thing: ``tensor_shard`` round-robins frames
(stamping a sequence number), each branch offloads to its own worker
(local filter or ``tensor_query_client``/``tensor_sink_grpc`` pair), and
``tensor_unshard`` restores arrival-order by sequence — the "multi-host
stream sharding with ordered re-join" of SURVEY.md §5.8/§7.

    ... ! tensor_shard name=s
          s.src_0 ! tensor_query_client port=P0 ! u.sink_0
          s.src_1 ! tensor_query_client port=P1 ! u.sink_1
          tensor_unshard name=u ! ...
"""
from __future__ import annotations

import heapq
import threading
from typing import List, Optional

from ..core import Buffer, Caps, Event
from ..registry.elements import register_element
from ..runtime.element import Element, ElementError, Prop
from ..runtime.pad import Pad, PadDirection, PadPresence, PadTemplate
from ..utils.log import logger

_TENSOR_CAPS = Caps.new("other/tensors")
SEQ_META = "shard_seq"


@register_element
class TensorShard(Element):
    """1 → N scatter; each frame goes to exactly ONE branch (unlike tee)
    and carries its global sequence number in ``meta["shard_seq"]``
    (also mirrored to ``Buffer.offset``).

    Dispatch is round-robin by default, or **weighted** (smooth weighted
    round-robin — nginx's deterministic spread, no RNG) when per-branch
    weights are set: ``weights=0.5,0.25,0.25`` in the launch line for a
    hand split, or :meth:`set_branch_weights` for the placement
    planner's profile-derived assignment (a branch twice as slow gets
    half the frames — ``runtime/placement.py``)."""

    ELEMENT_NAME = "tensor_shard"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    SRC_TEMPLATES = (
        PadTemplate("src_%u", PadDirection.SRC, _TENSOR_CAPS,
                    PadPresence.REQUEST),
    )
    PROPERTIES = {
        "weights": Prop("", str,
                        "comma-separated relative branch weights "
                        "(empty = uniform round-robin); the placement "
                        "planner overrides via set_branch_weights"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._seq = 0
        # (weights, credit) published as ONE tuple: the planner can
        # retune from a dispatching thread mid-stream, and the chain
        # path must never see new weights with the old credit list
        # (length tear -> IndexError)
        self._wrr: Optional[tuple] = None
        w = str(self.props.get("weights") or "").strip()
        if w:
            self.set_branch_weights([float(x) for x in w.split(",")])

    def set_branch_weights(self, weights: Optional[List[float]]) -> None:
        """Install per-branch weights (planner-produced assignment or a
        hand split); None/empty restores uniform round-robin. Takes
        effect on the next frame — safe while streaming (the chain path
        reads the (weights, credit) pair as one reference)."""
        if not weights:
            self._wrr = None
            return
        if any(w <= 0 for w in weights):
            raise ElementError(
                f"{self.describe()}: weights must be > 0, got {weights}")
        total = float(sum(weights))
        self._wrr = ([w / total for w in weights], [0.0] * len(weights))

    def reset_flow(self) -> None:
        super().reset_flow()
        self._seq = 0
        wrr = self._wrr
        if wrr is not None:
            self._wrr = (wrr[0], [0.0] * len(wrr[0]))

    def _pick(self, n: int) -> int:
        """Branch for the next frame: smooth weighted round-robin — each
        tick every branch gains its weight in credit, the richest branch
        pays 1 and wins; uniform weights reduce to exact round-robin."""
        wrr = self._wrr
        if wrr is None or len(wrr[0]) != n:
            # weight arity must match the linked branches; a mismatched
            # plan (branch added/removed) falls back to uniform rather
            # than starving branches silently
            return self._seq % n
        w, credit = wrr
        for i in range(n):
            credit[i] += w[i]
        best = max(range(n), key=lambda i: (credit[i], -i))
        credit[best] -= 1.0
        return best

    def chain(self, pad: Pad, buf: Buffer) -> None:
        linked = [p for p in self.src_pads if p.is_linked]
        if not linked:
            raise ElementError(f"{self.describe()}: no linked src pads")
        buf.meta[SEQ_META] = self._seq
        buf.offset = self._seq
        linked[self._pick(len(linked))].push(buf)
        self._seq += 1


@register_element
class TensorUnshard(Element):
    """N → 1 ordered re-join by ``shard_seq`` (falls back to
    ``Buffer.offset``). Out-of-order frames wait in a bounded heap; when a
    frame goes missing (worker died), the stall is bounded: once the heap
    holds ``max-buffered`` frames the gap is declared lost and skipped —
    the load-shedding stance of the reference's QoS path, applied to
    re-join (SURVEY.md §5.3)."""

    ELEMENT_NAME = "tensor_unshard"
    SINK_TEMPLATES = (
        PadTemplate("sink_%u", PadDirection.SINK, _TENSOR_CAPS,
                    PadPresence.REQUEST),
    )
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    PROPERTIES = {
        "max_buffered": Prop(64, int,
                             "frames held for reordering before declaring "
                             "a sequence gap lost"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._heap: List[tuple] = []   # (seq, tiebreak, Buffer)
        self._tiebreak = 0             # heapq never compares Buffers
        self._next = 0
        self._join_lock = threading.Lock()  # branches chain from own threads

    def reset_flow(self) -> None:
        super().reset_flow()
        with self._join_lock:  # vs branch threads still chaining at stop
            self._heap = []
            self._next = 0

    def maybe_negotiate(self) -> None:
        linked = [p for p in self.sink_pads if p.is_linked and p.caps is not None]
        if not linked:
            return
        # ALL negotiated branches must agree, including ones whose caps
        # arrive after the src pad was announced from the first branch
        first = linked[0].caps
        for p in linked[1:]:
            if str(p.caps) != str(first):
                raise ElementError(
                    f"{self.describe()}: branch caps diverge: {first} vs {p.caps}"
                )
        if self.srcpad.caps is None:
            self.srcpad.push_event(Event.caps(first))

    def chain(self, pad: Pad, buf: Buffer) -> None:
        seq = buf.meta.get(SEQ_META, buf.offset)
        if seq is None:
            raise ElementError(
                f"{self.describe()}: frame carries no shard_seq/offset "
                "(upstream must be tensor_shard or stamp offsets)"
            )
        # pushes happen under the same lock: ordered delivery means a second
        # branch must wait its turn anyway (downstream backpressure applies
        # to the join as a whole)
        with self._join_lock:
            heapq.heappush(self._heap, (int(seq), self._tiebreak, buf))
            self._tiebreak += 1
            self._drain(force=False)

    def _drain(self, force: bool) -> None:
        limit = max(1, int(self.props["max_buffered"]))
        while self._heap:
            seq, _, buf = self._heap[0]
            if seq < self._next:        # duplicate / late after declared loss
                heapq.heappop(self._heap)
                logger.warning("%s: dropping late frame seq=%d (next=%d)",
                               self.describe(), seq, self._next)
                continue
            if seq == self._next or force or len(self._heap) >= limit:
                if seq != self._next:
                    logger.warning("%s: sequence gap %d..%d declared lost",
                                   self.describe(), self._next, seq - 1)
                heapq.heappop(self._heap)
                self._next = seq + 1
                self.push(buf)
                continue
            break

    def handle_eos(self) -> None:
        with self._join_lock:
            self._drain(force=True)
        super().handle_eos()
