"""Profile-guided cross-device segment placement (L5).

The counterpart of nnstreamer_tpu's ``runtime/placement.py``. Fusion
(``runtime/fusion.py``) collapses linear device runs into one-dispatch
segments; the continuous profiler (``obs/profile.py``) persists what each
segment, element hop and queue wait costs as ``ProfileArtifact``s keyed
by (topology hash, caps, model version). This module reads a
:class:`~nnstreamer_tpu_torch.obs.profile.ProfileStore` and assigns the
pipeline's stages across the local CUDA cards (``torch.device("cuda",
i)`` in index order), then sizes the inter-stage ``queue`` depths from
the same profile's queue-wait digests.

The plan algebra (the reference's, unchanged):

* **stages** — ``fusion.plan_segments(min_run=1)``: every maximal linear
  run of fusable device elements, runs of one included. Stage keys are
  canonical, so one launch line maps onto the same artifact entries
  across restarts and replicas.
* **costs** — per-stage latency from the artifact, best channel first:
  ``fused_device`` (sampled device-complete) → ``fused`` (host dispatch)
  → sum of ``element`` hops → a uniform per-element heuristic when
  nothing matches (the *calibration* path below).
* **assignment** — minimize the max per-device load: exact search for
  realistic stage counts, LPT beyond that, under per-card byte budgets
  (``torch.cuda.mem_get_info``) when the artifact carries byte estimates.
* **queue depths** — ``depth = clamp(ceil(p99_wait / downstream_p50) +
  1, min, max)``, applied via ``QueueElement.set_capacity`` (counted in
  the queue's ``retuned`` stat).

Applying a plan: a fused segment is pinned with ``set_device`` (its
host inputs then ride the pinned stager, ``transport/staging.py``, and a
tensor from another card makes one ``.to(device, non_blocking=True)``
hop), and each ``tensor_filter`` of a stage gets a backend pin
(``set_placement_device``, the CUDA index) that applies when its backend
next opens; a user's ``custom=device:N`` always wins. A segment holding a
filter runs on the card the filter's backend opened on (its weights live
there), so a mid-run re-plan moves it only at the backend's next open.

Wiring: ``Pipeline(place="auto")`` / ``parse_launch(place=...)`` plans
at every ``play()``; a :class:`PlacementPlan` passed as ``place=``
applies verbatim. ``NNS_NO_PLACE=1`` is the kill switch. Re-planning
rides fusion's invalidation events: ``FusedSegment.invalidate`` marks
the plan dirty and the next segment *rebuild* refreshes it.

Calibration fallback: when no artifact matches the pipeline's key, the
planner installs a heuristic plan, opens a refcounted recording window
(``obs.profile.begin_calibration``), and a per-dispatch probe on the
fused segments closes it once every segment has seen
``CALIBRATION_DISPATCHES`` buffers: the live profile is captured, saved
to the store (``save(merge=True)``), and the plan is recomputed.

Observability: each plan lands as a ``placement`` span, the
``nns_placement_*`` gauges and a PLACEMENT section in ``obs top``.

``tensor_shard`` fan-outs get branch weights inversely proportional to
each branch's profiled downstream cost (``shard_weights``).

AOT artifact references: with a compile cache on (``NNS_AOT_CACHE``,
``aot/``) a plan names, in ``aot``, the saved program of each of its
stages that has one, so shipping the plan and those files hands over
both the placement and the programs it places.

Not here yet: the planner-assignment surfaces of ``parallel/pipeline``
(A7).
"""
from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import torch

from ..analysis.sanitizer import named_lock
from ..obs import context as obs_context
from ..obs import flight as obs_flight
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..utils.log import logger
from . import fusion

if TYPE_CHECKING:
    from .pipeline import Pipeline

SCHEMA_VERSION = 1

#: fused dispatches per segment before a calibration window closes and
#: the plan is recomputed from the measured profile (3 sampled device
#: probes at the segment's PROBE_EVERY=16 cadence)
CALIBRATION_DISPATCHES = 48

#: planner-tuned queue depth bounds: deep enough for real jitter, never
#: deeper than memory/latency sanity allows
MIN_QUEUE_DEPTH = 2
MAX_QUEUE_DEPTH = 64

#: uniform per-element stage cost (ms) when nothing is profiled — only
#: RELATIVE costs matter to the assignment, so any constant works; 1 ms
#: keeps heuristic plans human-readable
HEURISTIC_ELEMENT_MS = 1.0


# ---------------------------------------------------------------------------
# plan model (serializable — a plan ships to replicas)
# ---------------------------------------------------------------------------

@dataclass
class StagePlacement:
    """One stage's assignment: ``stage`` is the canonical segment key
    (``head..tail`` for fused runs, the element's canonical name for
    singletons), ``device`` an index into :attr:`PlacementPlan.devices`.
    ``bytes`` is the stage's profiled static memory footprint (params +
    temp + output + argument + code, from the artifact's ``memory``
    section — obs/memory.py); 0 = unprofiled, unconstrained."""

    stage: str
    elements: List[str]
    device: int
    cost_ms: float
    p99_ms: float
    source: str  # "profile" | "heuristic"
    bytes: int = 0

    def to_dict(self) -> dict:
        return {"stage": self.stage, "elements": list(self.elements),
                "device": self.device, "cost_ms": round(self.cost_ms, 6),
                "p99_ms": round(self.p99_ms, 6), "source": self.source,
                "bytes": int(self.bytes)}

    @classmethod
    def from_dict(cls, d: dict) -> "StagePlacement":
        return cls(str(d["stage"]), [str(e) for e in d.get("elements", [])],
                   int(d["device"]), float(d.get("cost_ms", 0.0)),
                   float(d.get("p99_ms", 0.0)),
                   str(d.get("source", "heuristic")),
                   int(d.get("bytes", 0)))


@dataclass
class PlacementPlan:
    """A complete, serializable placement decision for one topology.

    ``devices`` are labels (``cuda:0``) in local card order — the
    *indices* are what applies; a plan shipped to a replica with the
    same device count applies verbatim. ``queues`` maps canonical queue
    names to tuned depths, ``shard_weights`` maps ``tensor_shard`` names
    to per-branch weights."""

    pipeline: str = ""
    key: Dict[str, str] = field(default_factory=dict)
    devices: List[str] = field(default_factory=list)
    stages: List[StagePlacement] = field(default_factory=list)
    queues: Dict[str, dict] = field(default_factory=dict)
    shard_weights: Dict[str, List[float]] = field(default_factory=dict)
    source: str = "heuristic"  # "profile" | "heuristic" | "explicit"
    balance: Dict[str, float] = field(default_factory=dict)
    # AOT compile-cache artifact refs ({stage id: artifact basename}),
    # the reference's schema
    aot: Dict[str, str] = field(default_factory=dict)

    def stage_for(self, stage_key: str) -> Optional[StagePlacement]:
        for st in self.stages:
            if st.stage == stage_key:
                return st
        return None

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "kind": "nns-placement",
            "pipeline": self.pipeline,
            "key": dict(self.key),
            "devices": list(self.devices),
            "stages": [s.to_dict() for s in self.stages],
            "queues": {k: dict(v) for k, v in sorted(self.queues.items())},
            "shard_weights": {k: list(v) for k, v
                              in sorted(self.shard_weights.items())},
            "source": self.source,
            "balance": dict(self.balance),
            "aot": dict(sorted(self.aot.items())),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlacementPlan":
        if d.get("kind") != "nns-placement":
            raise ValueError("not a placement plan (kind != nns-placement)")
        return cls(
            pipeline=d.get("pipeline", ""),
            key=dict(d.get("key", {})),
            devices=[str(x) for x in d.get("devices", [])],
            stages=[StagePlacement.from_dict(s) for s in d.get("stages", [])],
            queues={str(k): dict(v)
                    for k, v in (d.get("queues") or {}).items()},
            shard_weights={str(k): [float(w) for w in v]
                           for k, v in (d.get("shard_weights") or {}).items()},
            source=d.get("source", "explicit"),
            balance=dict(d.get("balance", {})),
            aot={str(k): str(v) for k, v in (d.get("aot") or {}).items()},
        )

    def describe(self) -> str:
        parts = [f"{s.stage}->dev{s.device}" for s in self.stages]
        return "; ".join(parts) if parts else "(no stages)"


# ---------------------------------------------------------------------------
# stage keys / cost extraction
# ---------------------------------------------------------------------------

def stage_key(elements: Sequence) -> str:
    """Canonical artifact key for a run of elements: matches the fused
    profiler series (``head..tail``, pipeline prefix stripped) so plan
    stages line up with ProfileArtifact entries across restarts."""
    head = obs_profile.canonical_base(elements[0])
    if len(elements) == 1:
        return head
    return f"{head}..{obs_profile.canonical_base(elements[-1])}"


def _entry_quantiles(entry: Optional[dict]) -> Optional[tuple]:
    if not entry or not entry.get("count"):
        return None
    dig = entry["digest"]
    return (dig.quantile(0.5) * 1e3, dig.quantile(0.99) * 1e3)


def _stage_cost(artifact, elements: Sequence) -> tuple:
    """(p50_ms, p99_ms, source) for one stage. Channel preference:
    sampled device-complete latency, host dispatch time, element-hop
    sum, uniform heuristic — in that order of honesty."""
    if artifact is not None:
        key = stage_key(elements)
        for scope in ("fused_device", "fused"):
            q = _entry_quantiles(artifact.entries.get(scope, {}).get(key))
            if q is not None:
                return q[0], q[1], "profile"
        hops = artifact.entries.get("element", {})
        p50 = p99 = 0.0
        found = 0
        for el in elements:
            q = _entry_quantiles(hops.get(obs_profile.canonical_base(el)))
            if q is not None:
                p50 += q[0]
                p99 += q[1]
                found += 1
        if found == len(elements) and found > 0:
            return p50, p99, "profile"
    cost = HEURISTIC_ELEMENT_MS * len(elements)
    return cost, cost, "heuristic"


def _stage_bytes(artifact, elements: Sequence) -> int:
    """Profiled static memory footprint of one stage from the artifact's
    ``memory`` section (obs/memory.py): the fused-segment entry first,
    the sum of singleton member entries otherwise, 0 (= unconstrained)
    when nothing was captured."""
    mem = getattr(artifact, "memory", None) if artifact is not None else None
    if not mem:
        return 0
    cell = mem.get(stage_key(elements))
    if cell is not None:
        return int(cell.get("total_bytes", 0) or 0)
    total = 0
    for el in elements:
        cell = mem.get(obs_profile.canonical_base(el))
        if cell is not None:
            total += int(cell.get("total_bytes", 0) or 0)
    return total


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

class Planner:
    """Turns (topology, ProfileStore) into a :class:`PlacementPlan`.

    Deterministic by construction: the same store contents and device
    list always yield an identical plan (stable stage order, stable LPT
    tie-breaks) — the property the plan-cache/AOT consumers and the
    determinism tests rely on."""

    def __init__(self, store: Optional[object] = None,
                 devices: Optional[Sequence] = None,
                 min_queue_depth: int = MIN_QUEUE_DEPTH,
                 max_queue_depth: int = MAX_QUEUE_DEPTH,
                 hbm_budget_bytes: Optional[int] = None):
        self._store = store
        self._devices = list(devices) if devices is not None else None
        self.min_queue_depth = int(min_queue_depth)
        self.max_queue_depth = int(max_queue_depth)
        # the memory constraint (obs/memory.py): per-device budget
        # in bytes. None = auto — per card, its total memory
        # (``torch.cuda.mem_get_info``), else the NNS_HBM_BUDGET env
        # budget, else unconstrained. With a budget and profiled per-stage byte
        # estimates the planner derives the co-residency cap itself:
        # bin-pack on bytes as a feasibility constraint inside the
        # exact/LPT balance search — no stage-count knob needed.
        self.hbm_budget_bytes = hbm_budget_bytes

    # -- inputs --------------------------------------------------------------
    @property
    def store(self):
        if self._store is None:
            self._store = obs_profile.default_store()
        return self._store

    @property
    def devices(self) -> list:
        """Local cards in CUDA index order (an empty list without a
        card: every stage then lands on index 0 and nothing is pinned)."""
        if self._devices is None:
            if torch.cuda.is_available():
                self._devices = [torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count())]
            else:
                self._devices = []
        return self._devices

    def device_budgets(self) -> List[Optional[int]]:
        """Per-device memory budget in bytes, aligned with
        :attr:`devices`: the explicit ``hbm_budget_bytes`` when given,
        else the card's total (``torch.cuda.mem_get_info``), else the
        process budget (``NNS_HBM_BUDGET``); None entries are
        unconstrained."""
        fallback = obs_memory.default_budget_bytes()
        budgets: List[Optional[int]] = []
        for d in self.devices:
            b = self.hbm_budget_bytes
            if (b is None and isinstance(d, torch.device)
                    and d.type == "cuda"):
                try:
                    b = torch.cuda.mem_get_info(d)[1]
                except Exception:  # noqa: BLE001 - card without stats
                    b = None
            if b is None:
                b = fallback
            budgets.append(int(b) if b else None)
        return budgets

    def artifact_for(self, pipeline: "Pipeline", model_version: str = ""):
        """The stored profile matching this pipeline's key: the exact
        (topology, caps, model version) first, then the same topology
        under ANY caps — a fresh process plans BEFORE negotiation has
        produced caps, and an artifact captured on the negotiated stream
        is keyed by them (the scan is sorted for determinism)."""
        store = self.store
        if store is None:
            return None
        topo = obs_profile.topology_hash(pipeline)
        for caps in (obs_profile._negotiated_caps(pipeline), ""):
            art = store.load({"topology": topo, "caps": caps,
                              "model_version": model_version})
            if art is not None:
                return art
        for entry in sorted(store.list(),
                            key=lambda e: (e.get("caps", ""),
                                           e.get("path", ""))):
            if (entry.get("topology") == topo
                    and entry.get("model_version", "") == model_version):
                try:
                    return obs_profile.ProfileArtifact.load(entry["path"])
                except (OSError, ValueError, KeyError):
                    continue
        return None

    #: pass as ``artifact=`` to record "the store was already consulted
    #: and missed" — plan() then skips its own lookup (install() would
    #: otherwise pay the store directory scan twice per play on a miss)
    NO_ARTIFACT = object()

    # -- planning ------------------------------------------------------------
    def plan(self, pipeline: "Pipeline", artifact=None,
             model_version: str = "") -> PlacementPlan:
        """Compute the placement for ``pipeline``. Pure function of
        (topology, artifact, devices) — applies nothing."""
        if artifact is Planner.NO_ARTIFACT:
            artifact = None
        elif artifact is None:
            artifact = self.artifact_for(pipeline, model_version)
        seg_plan = fusion.plan_segments(pipeline, min_run=1)
        devices = self.devices
        n_dev = max(1, len(devices))
        plan = PlacementPlan(
            pipeline=pipeline.name,
            key={"topology": obs_profile.topology_hash(pipeline),
                 "caps": obs_profile._negotiated_caps(pipeline),
                 "model_version": model_version},
            devices=[_label(d, i) for i, d in enumerate(devices)],
        )

        costs: Dict[str, tuple] = {}
        for elements in seg_plan.segments:
            key = stage_key(elements)
            costs[key] = _stage_cost(artifact, elements)
            plan.stages.append(StagePlacement(
                stage=key,
                elements=[obs_profile.canonical_base(e) for e in elements],
                device=0, cost_ms=costs[key][0], p99_ms=costs[key][1],
                source=costs[key][2],
                bytes=_stage_bytes(artifact, elements)))
        plan.source = ("profile" if artifact is not None
                       and any(s.source == "profile" for s in plan.stages)
                       else "heuristic")

        budgets = self.device_budgets()
        load, dev_bytes, byte_feasible = self._assign(
            plan.stages, n_dev, budgets=budgets)

        critical = sum(s.cost_ms for s in plan.stages)
        max_load = max(load) if plan.stages else 0.0
        target = critical / n_dev if critical else 0.0
        plan.balance = {
            "critical_path_ms": round(critical, 6),
            "max_stage_ms": round(max_load, 6),
            "target_ms": round(target, 6),
            # 1.0 = perfectly balanced; a single dominant segment can
            # push this up — the planner cannot split inside a segment
            "ratio": round(max_load / target, 4) if target else 1.0,
            "n_devices": n_dev,
            # memory side (obs/memory.py): what the byte constraint saw
            "stage_bytes_total": sum(s.bytes for s in plan.stages),
            "max_device_bytes": max(dev_bytes) if dev_bytes else 0,
            "budget_bytes": min((b for b in budgets if b), default=0),
            "byte_feasible": byte_feasible,
        }

        self._tune_queues(pipeline, artifact, plan)
        self._shard_weights(pipeline, artifact, plan)
        # reference the saved programs: stages whose exported artifact
        # exists are named in the plan
        from .. import aot as aot_cache

        cache = aot_cache.default_cache()
        if cache is not None:
            refs = cache.stage_artifacts(plan.key.get("topology", ""))
            stages = {s.stage for s in plan.stages}
            plan.aot = {k: v for k, v in refs.items() if k in stages}
        return plan

    # makespan minimization (multiprocessor scheduling) is NP-hard in
    # general; real pipelines have a handful of stages, so up to this
    # many candidate assignments the planner just takes the exact
    # optimum (still << one capture on the rebuild path where
    # re-planning runs)
    EXACT_SEARCH_LIMIT = 65536

    def _assign(self, stages: List[StagePlacement], n_dev: int,
                budgets: Optional[Sequence[Optional[int]]] = None
                ) -> tuple:
        """Assign stages to devices minimizing the max per-device load
        under a feasibility constraint — when per-stage byte estimates
        and per-device budgets exist — the **byte budget**
        (each stage's params + activations are resident on its chip, so
        the sum of co-resident stage bytes must fit the chip). Exact
        enumeration when the space is small — "auto matches the best
        hand placement among FEASIBLE assignments" is structural, not
        heuristic — LPT (longest-processing-time-first onto the
        least-loaded eligible device) beyond that. Deterministic: the
        exact path takes the lexicographically-smallest optimum in
        stage order; LPT breaks ties on stage key then device index.

        Returns ``(load_ms, device_bytes, byte_feasible)``. When no
        byte-feasible assignment exists at all (a stage alone outgrows
        every budget, or the packing cannot fit), the byte constraint is
        dropped with a warning + ``memory`` flight event — a plan MUST
        always come out — and ``byte_feasible`` reports False."""
        if not stages:
            return [0.0] * n_dev, [0] * n_dev, True
        budgets = (list(budgets) if budgets is not None
                   else [None] * n_dev)
        budgets += [None] * (n_dev - len(budgets))
        constrained = (any(b is not None for b in budgets)
                       and any(s.bytes for s in stages))
        result = self._assign_under(stages, n_dev,
                                    budgets if constrained else
                                    [None] * n_dev)
        if result is not None:
            load, dev_bytes = result
            return load, dev_bytes, self._fits(dev_bytes, budgets)
        # byte-infeasible everywhere: relax and report
        logger.warning(
            "placement: no byte-feasible assignment of %d stages "
            "(total %d bytes) under budgets %s — relaxing the memory "
            "constraint", len(stages), sum(s.bytes for s in stages),
            budgets)
        obs_flight.record("memory", "placement_infeasible",
                          {"stages": len(stages),
                           "stage_bytes": sum(s.bytes for s in stages),
                           "budgets": [b or 0 for b in budgets]})
        load, dev_bytes = self._assign_under(stages, n_dev,
                                             [None] * n_dev)
        return load, dev_bytes, False

    @staticmethod
    def _fits(dev_bytes: List[int],
              budgets: Sequence[Optional[int]]) -> bool:
        return all(b is None or used <= b
                   for used, b in zip(dev_bytes, budgets))

    def _assign_under(self, stages: List[StagePlacement], n_dev: int,
                      budgets: Sequence[Optional[int]]
                      ) -> Optional[tuple]:
        """One constrained search pass; None when the exact search finds
        no feasible assignment (only possible with byte budgets)."""
        if n_dev ** len(stages) <= self.EXACT_SEARCH_LIMIT:
            import itertools

            best: Optional[tuple] = None
            for combo in itertools.product(range(n_dev), repeat=len(stages)):
                load = [0.0] * n_dev
                mem = [0] * n_dev
                ok = True
                for st, dev in zip(stages, combo):
                    mem[dev] += st.bytes
                    if budgets[dev] is not None and mem[dev] > budgets[dev]:
                        ok = False
                        break
                    load[dev] += st.cost_ms
                if not ok:
                    continue
                key = (max(load), combo)
                if best is None or key < best:
                    best = key + (load, mem)
            if best is None:
                return None  # byte budgets forbade every assignment
            for st, dev in zip(stages, best[1]):
                st.device = dev
            return best[2], best[3]
        load = [0.0] * n_dev
        mem = [0] * n_dev
        over_budget = False
        for st in sorted(stages, key=lambda s: (-s.cost_ms, s.stage)):
            eligible = [i for i in range(n_dev)
                        if budgets[i] is None
                        or mem[i] + st.bytes <= budgets[i]]
            if not eligible:
                # no device has byte headroom: this greedy packing
                # failed — report None so _assign relaxes with the same
                # warning + flight event the exact path emits (greedy
                # LPT is a heuristic; a feasible packing may exist, but
                # a silently over-budget plan must never come out as
                # byte_feasible)
                over_budget = True
                eligible = range(n_dev)
            idx = min(eligible, key=lambda i: (load[i], i))
            st.device = idx
            load[idx] += st.cost_ms
            mem[idx] += st.bytes
        if over_budget and any(b is not None for b in budgets):
            return None
        return load, mem

    def _tune_queues(self, pipeline: "Pipeline", artifact,
                     plan: PlacementPlan) -> None:
        """Size each queue from its profiled wait digest: the depth must
        hold the burst a p99 wait implies at the downstream stage's
        service rate; no profile ⇒ the user's depth stands."""
        if artifact is None:
            return
        waits = artifact.entries.get("queue_wait", {})
        # downstream stage p50 per queue: the first planned stage
        # reachable through the queue's src pad
        stage_of = {}
        for st in plan.stages:
            for el_name in st.elements:
                stage_of[el_name] = st
        mean_cost = ([s.cost_ms for s in plan.stages] or [HEURISTIC_ELEMENT_MS])
        fallback_ms = sum(mean_cost) / len(mean_cost)
        for el in pipeline.elements.values():
            if el.ELEMENT_NAME != "queue":
                continue
            canon = obs_profile.canonical_base(el)
            q = _entry_quantiles(waits.get(canon))
            if q is None:
                continue
            _, wait_p99_ms = q
            nxt = None
            for pad in el.src_pads:
                if pad.peer is not None:
                    nxt = stage_of.get(
                        obs_profile.canonical_base(pad.peer.element))
            service_ms = max(nxt.cost_ms if nxt is not None else fallback_ms,
                             1e-3)
            depth = int(math.ceil(wait_p99_ms / service_ms)) + 1
            depth = max(self.min_queue_depth,
                        min(self.max_queue_depth, depth))
            plan.queues[canon] = {
                "depth": depth,
                "wait_p99_ms": round(wait_p99_ms, 6),
                "service_ms": round(service_ms, 6),
            }

    def _shard_weights(self, pipeline: "Pipeline", artifact,
                       plan: PlacementPlan) -> None:
        """Weight ``tensor_shard`` branches inversely to their profiled
        downstream cost (a branch twice as slow gets half the frames)."""
        if artifact is None:
            return
        hops = artifact.entries.get("element", {})
        for el in pipeline.elements.values():
            if el.ELEMENT_NAME != "tensor_shard":
                continue
            branch_costs: List[float] = []
            for pad in el.src_pads:
                if pad.peer is None:
                    continue
                cost = 0.0
                cur = pad.peer.element
                seen = set()
                while cur is not None and id(cur) not in seen:
                    seen.add(id(cur))
                    if cur.ELEMENT_NAME == "tensor_unshard":
                        break
                    q = _entry_quantiles(
                        hops.get(obs_profile.canonical_base(cur)))
                    if q is not None:
                        cost += q[0]
                    nxt = None
                    for sp in cur.src_pads:
                        if sp.peer is not None:
                            nxt = sp.peer.element
                            break
                    cur = nxt
                branch_costs.append(cost)
            if len(branch_costs) >= 2 and all(c > 0 for c in branch_costs):
                inv = [1.0 / c for c in branch_costs]
                total = sum(inv)
                plan.shard_weights[el.name] = [round(w / total, 6)
                                               for w in inv]


# ---------------------------------------------------------------------------
# runtime wiring: per-pipeline state, apply, calibration, re-plan
# ---------------------------------------------------------------------------

class _PlacementState:
    """Everything placement hangs off one playing pipeline: the current
    plan, the dirty flag fusion's invalidation path sets, and the
    calibration window. Lock order: leaf under everything — taken bare,
    and takes only FusedSegment/queue locks sequentially via apply."""

    def __init__(self, pipeline: "Pipeline", planner: Planner,
                 plan: PlacementPlan, explicit: bool = False):
        self._pipe = weakref.ref(pipeline)
        self.planner = planner
        self.plan = plan
        # an explicit (serialized, user-supplied) plan is authoritative:
        # invalidation events re-APPLY it to the fresh segments, they
        # never recompute it away
        self.explicit = explicit
        self._lock = named_lock(f"PlacementState._lock:{pipeline.name}")
        self._dirty = False          # guarded-by: _lock
        self._calibrating = False    # guarded-by: _lock
        self.replans = 0             # guarded-by: _lock

    # -- invalidation (fusion calls these) -----------------------------------
    def mark_dirty(self) -> None:
        with self._lock:
            self._dirty = True

    def refresh_if_dirty(self) -> None:
        """Re-plan + re-apply if an invalidation event landed since the
        last plan. Runs on the segment REBUILD path (fusion._build), so
        the steady-state dispatch never pays for it."""
        with self._lock:
            if not self._dirty:
                return
            self._dirty = False
        pipe = self._pipe()
        if pipe is None:
            return
        self.replan(pipe)

    def replan(self, pipeline: "Pipeline") -> None:
        t0 = time.monotonic()
        if self.explicit:
            # authoritative plan: the invalidation replaced the fused
            # segments / backend state, so re-apply the SAME assignment
            with self._lock:
                plan = self.plan
                self.replans += 1
        else:
            plan = self.planner.plan(pipeline)
            with self._lock:
                self.plan = plan
                self.replans += 1
        _apply(pipeline, plan, self.planner.devices)
        _emit_plan(pipeline, plan, time.monotonic() - t0, replan=True)

    # -- calibration ---------------------------------------------------------
    def begin_calibration(self, pipeline: "Pipeline") -> None:
        segments = pipeline.fused_segments
        if not segments:
            return  # nothing produces fused samples; stay heuristic
        with self._lock:
            if self._calibrating:
                return
            self._calibrating = True
        obs_profile.begin_calibration()
        # byte estimates ride the same window: the artifact captured at
        # window close carries the memory section the auto-cap needs
        obs_memory.begin_calibration()
        for seg in segments:
            seg._placement_probe = self._calibration_probe
        logger.info("placement %s: no profile artifact — calibrating over "
                    "%d fused dispatches per segment", pipeline.name,
                    CALIBRATION_DISPATCHES)

    def _calibration_probe(self, seg) -> None:
        """Per-dispatch hook (only while obs recording is on): close the
        window once every probed segment has enough samples."""
        if seg.stats["dispatches"] < CALIBRATION_DISPATCHES:
            return
        pipe = self._pipe()
        if pipe is None:
            self.close()
            return
        if any(s.stats["dispatches"] < CALIBRATION_DISPATCHES
               for s in pipe.fused_segments):
            return
        self.finish_calibration(pipe)

    def finish_calibration(self, pipeline: "Pipeline") -> None:
        """Capture the measured profile, persist it, re-plan from it.
        Runs inline on the dispatching thread exactly once — planning is
        microseconds against a handful of stages."""
        with self._lock:
            if not self._calibrating:
                return
            self._calibrating = False
        for seg in pipeline.fused_segments:
            seg._placement_probe = None
        try:
            artifact = obs_profile.ProfileArtifact.capture(pipeline)
            store = self.planner.store
            if store is not None:
                store.save(artifact, merge=True)
            t0 = time.monotonic()
            plan = self.planner.plan(pipeline, artifact=artifact)
            with self._lock:
                self.plan = plan
                self.replans += 1
            _apply(pipeline, plan, self.planner.devices)
            _emit_plan(pipeline, plan, time.monotonic() - t0, replan=True)
            logger.info("placement %s: calibration complete — %s",
                        pipeline.name, plan.describe())
        finally:
            obs_profile.end_calibration()
            obs_memory.end_calibration()

    def close(self) -> None:
        """End-of-run cleanup: an open calibration window must not leak
        its recording refcount past stop()."""
        with self._lock:
            was = self._calibrating
            self._calibrating = False
        if was:
            pipe = self._pipe()
            for seg in (pipe.fused_segments if pipe is not None else []):
                seg._placement_probe = None
            obs_profile.end_calibration()
            obs_memory.end_calibration()

    def snapshot(self) -> dict:
        with self._lock:
            plan = self.plan
            replans = self.replans
            calibrating = self._calibrating
        out = plan.to_dict()
        out["replans"] = replans
        out["calibrating"] = calibrating
        return out


# ---------------------------------------------------------------------------
# apply / install / uninstall
# ---------------------------------------------------------------------------

def _apply(pipeline: "Pipeline", plan: PlacementPlan,
           devices: Sequence) -> None:
    """Push a plan into the live graph: fused-segment device pins
    (re-captured lazily on the next buffer), tensor_filter backend pins
    for singleton stages and fused members (consumed at backend open —
    a user's ``custom=device:N`` always wins), tuned queue depths and
    ``tensor_shard`` branch weights."""
    by_canon = {obs_profile.canonical_base(el): el
                for el in pipeline.elements.values()}
    placed = set()
    for seg in pipeline.fused_segments:
        st = plan.stage_for(stage_key(seg.elements))
        if st is None or st.device >= len(devices):
            continue
        seg.set_device(devices[st.device])
        for el in seg.elements:
            if hasattr(el, "set_placement_device"):
                el.set_placement_device(_global_index(devices[st.device]))
        placed.add(st.stage)
    for st in plan.stages:
        if st.stage in placed or len(st.elements) != 1:
            continue
        el = by_canon.get(st.elements[0])
        if el is not None and hasattr(el, "set_placement_device") \
                and st.device < len(devices):
            el.set_placement_device(_global_index(devices[st.device]))
    for canon, q in plan.queues.items():
        el = by_canon.get(canon)
        if el is not None and hasattr(el, "set_capacity"):
            el.set_capacity(int(q["depth"]))
    for name, weights in plan.shard_weights.items():
        el = pipeline.elements.get(name)
        if el is not None and hasattr(el, "set_branch_weights"):
            el.set_branch_weights(weights)


def _label(device, i: int) -> str:
    """A plan's device label: ``type:index`` for a torch device
    (``cuda:0``), ``platform:id`` for anything else."""
    if isinstance(device, torch.device):
        return f"{device.type}:{device.index if device.index is not None else i}"
    return f"{getattr(device, 'platform', 'cpu')}:{getattr(device, 'id', i)}"


def _global_index(device) -> Optional[int]:
    """The CUDA index of a planner device. The backend pin addresses the
    card by its global index — a planner built over a subset of the
    cards must not leak its local index into it (fused segments are
    immune: they pin by device object). None for anything but a card."""
    if isinstance(device, torch.device) and device.type == "cuda":
        return device.index if device.index is not None else 0
    return None

def _emit_plan(pipeline: "Pipeline", plan: PlacementPlan, plan_s: float,
               replan: bool = False) -> None:
    if obs_context.TRACING:
        obs_context.record_span(
            f"placement:plan:{pipeline.name}", kind="placement",
            start_s=time.monotonic() - plan_s, dur_s=plan_s,
            attrs={"stages": len(plan.stages),
                   "devices": plan.balance.get("n_devices", 0),
                   "source": plan.source, "replan": replan})
    logger.info("placement %s (%s%s): %s | queues %s", pipeline.name,
                plan.source, ", replan" if replan else "",
                plan.describe(),
                {k: v["depth"] for k, v in plan.queues.items()} or "untouched")


def install(pipeline: "Pipeline", planner: Optional[Planner] = None
            ) -> Optional[PlacementPlan]:
    """Plan + apply at ``play()`` (after ``fusion.install``). The
    ``place`` mode the pipeline carries decides the path: ``"auto"``
    plans from the store (calibrating on a miss), a
    :class:`PlacementPlan` instance applies verbatim (``explicit``)."""
    uninstall(pipeline)
    mode = getattr(pipeline, "place", None)
    if not mode:
        return None
    t0 = time.monotonic()
    planner = planner or Planner()
    explicit = isinstance(mode, PlacementPlan)
    if explicit:
        plan = mode
        plan.source = "explicit"
        artifact = True  # an explicit plan never calibrates
    else:
        artifact = planner.artifact_for(pipeline)
        plan = planner.plan(
            pipeline,
            artifact=artifact if artifact is not None
            else Planner.NO_ARTIFACT)
    state = _PlacementState(pipeline, planner, plan, explicit=explicit)
    pipeline._placement_state = state
    _apply(pipeline, plan, planner.devices)
    _track(pipeline)
    _emit_plan(pipeline, plan, time.monotonic() - t0)
    if artifact is None:
        state.begin_calibration(pipeline)
    return plan


def uninstall(pipeline: "Pipeline") -> None:
    """Drop placement state (closing any open calibration window) and
    clear per-element pins. Fused segments are re-created by
    ``fusion.install`` each play, so their pins die with them."""
    state = getattr(pipeline, "_placement_state", None)
    if state is not None:
        state.close()
    pipeline._placement_state = None
    for el in pipeline.elements.values():
        if hasattr(el, "set_placement_device"):
            el.set_placement_device(None)


def on_stop(pipeline: "Pipeline") -> None:
    """Pipeline.stop() hook: a calibration window must not outlive the
    run that was feeding it samples, and the stopped pipeline's
    ``nns_placement_*`` gauge rows leave the scrape immediately (the
    weak set alone keeps them visible until GC runs; install() at the
    next play re-tracks)."""
    state = getattr(pipeline, "_placement_state", None)
    if state is not None:
        state.close()
    _tracked_placed.discard(pipeline)


# ---------------------------------------------------------------------------
# observability: gauges collector + snapshot for /profile and obs top
# ---------------------------------------------------------------------------

_tracked_placed: "weakref.WeakSet" = weakref.WeakSet()

_G_STAGE_DEV = obs_metrics.gauge(
    "nns_placement_stage_device",
    "planner-assigned device index per pipeline stage",
    ("pipeline", "stage"))
_G_STAGE_COST = obs_metrics.gauge(
    "nns_placement_stage_cost_ms",
    "profiled (or heuristic) per-buffer stage cost the plan balanced",
    ("pipeline", "stage"))
_G_QUEUE_DEPTH = obs_metrics.gauge(
    "nns_placement_queue_depth",
    "planner-tuned inter-stage queue depth",
    ("pipeline", "queue"))
_G_BALANCE = obs_metrics.gauge(
    "nns_placement_balance_ratio",
    "max per-device load over the 1/N critical-path target (1.0 = balanced)",
    ("pipeline",))
_G_REPLANS = obs_metrics.gauge(
    "nns_placement_replans_total",
    "plan recomputations (calibration close, caps events, hot swaps)",
    ("pipeline",))


def _track(pipeline: "Pipeline") -> None:
    _tracked_placed.add(pipeline)


def _collect_placement(_registry) -> None:
    for g in (_G_STAGE_DEV, _G_STAGE_COST, _G_QUEUE_DEPTH, _G_BALANCE,
              _G_REPLANS):
        g.clear()
    for pipe in list(_tracked_placed):
        state = getattr(pipe, "_placement_state", None)
        if state is None:
            continue
        snap = state.snapshot()
        for st in snap["stages"]:
            _G_STAGE_DEV.set(st["device"], pipeline=pipe.name,
                             stage=st["stage"])
            _G_STAGE_COST.set(st["cost_ms"], pipeline=pipe.name,
                              stage=st["stage"])
        for qname, q in snap["queues"].items():
            _G_QUEUE_DEPTH.set(q["depth"], pipeline=pipe.name, queue=qname)
        _G_BALANCE.set(snap["balance"].get("ratio", 1.0), pipeline=pipe.name)
        _G_REPLANS.set(snap["replans"], pipeline=pipe.name)


obs_metrics.register_collector("placement", _collect_placement)


def snapshot_all() -> List[dict]:
    """Plans of every live placed pipeline — the ``placement`` block of
    ``GET /profile`` and the PLACEMENT section of ``obs top``."""
    out = []
    for pipe in list(_tracked_placed):
        state = getattr(pipe, "_placement_state", None)
        if state is not None:
            out.append(state.snapshot())
    return sorted(out, key=lambda d: d.get("pipeline", ""))
