"""Fleet observability: cross-process scrape, merge, and trace stitch (L7).

Process replicas (``service/procreplica.py``) each keep their own
observability planes: traces, profile digests, memory watermarks,
quality sketches and the flight recorder all live inside ONE process,
invisible to the parent that routes, autoscales, and promotes canaries
across them. This module is the parent-side join:

:class:`FleetView`
    Discovers every replica's control endpoint (from a
    :class:`~..service.procreplica.ProcReplicaSet` / ``ReplicaPool``
    via ``control_endpoints()``, or from static endpoints), scrapes
    ``/metrics``, ``/profile?raw=1``, ``/flight?after=``, ``/memory``,
    and ``/quality?raw=1`` on a tick thread with bounded staleness, and
    merges the planes into one coherent fleet snapshot:

    * **latency digests merge EXACTLY** — the profiler's bucket-wise merge
      guarantee means the fleet p99 IS the pooled p99 (same
      ``QuantileDigest`` algebra, over the wire as bucket dicts);
    * **memory merges max-watermark** per field (a footprint is a
      high-water mark — same semantics as the artifact ``memory``
      section);
    * **quality sketches merge additively** with exact histogram merge
      (a health sketch is a sample population —
      :func:`~.quality.merge_cells`);
    * **flight events interleave by timestamp** with a ``replica`` tag
      into one fleet stream (the ``obs flight --follow --fleet``
      surface), each event stamped with a fleet-local cursor seq.

    Cross-process **trace stitching**: child replicas already mint
    spans for the trace ids that ride the query wire; each process
    exports them wall-clock-annotated at ``GET /spans?trace=``
    (obs/context.py ``export_spans``), and :meth:`FleetView.stitch_trace`
    joins parent + replica spans into ONE Perfetto document — root →
    attempt → the subprocess replica's serving/fused spans, one
    trace_id, per-process ``pid`` lanes named after the replica id.

    **SLO / autoscaler facade**: :meth:`FleetView.request_window` has
    the exact signature the SLO engine and the autoscaler read burn
    rates through (``profiler.request_window``), returning the
    fleet-merged window digest — so ``SloEngine(profiler=fleet)`` and
    ``Autoscaler(..., fleet=fleet)`` compute burn over the MERGED
    series and survive any single replica whose local recorder
    restarted.

Cost contract: the fleet plane adds ZERO hot-path cost — everything
happens on the scrape tick thread (``fleet:<name>``); no data-plane
hook changes. The microbench disabled-path gates are untouched by
construction.

Surfaces: ``nns_fleet_*`` gauges (per-replica labeled + fleet rollups)
at ``GET /metrics``, ``GET /fleet`` on the parent control plane,
``python -m nnstreamer_tpu_torch obs fleet``, and the FLEET section of
``obs top``. See docs/observability.md#fleet for the scrape contract
and per-plane merge semantics.
"""
from __future__ import annotations

import collections
import copy
import itertools
import json
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from ..analysis.sanitizer import named_lock
from ..utils.log import logger
from . import context as obs_context
from . import flight as obs_flight
from . import metrics as obs_metrics
from . import promtext
from .profile import QuantileDigest

#: duration scopes whose series names carry a ``<pipeline>:`` prefix —
#: replicas of one launch line have DIFFERENT pipeline names (their
#: service name is the ring identity), so the fleet merge strips the
#: prefix to line the same stage up across replicas (the same strip
#: ``ProfileArtifact.capture`` applies)
_PIPELINE_SCOPES = ("element", "fused", "fused_device", "queue_wait")

#: series-name heads that are deployment-shaped, not pipeline-shaped —
#: never stripped
_KEEP_HEADS = ("serving", "fabric")

#: the replica tag the parent process's own planes merge under
PARENT_REPLICA = "_parent"


class FleetError(Exception):
    """Fleet scrape/stitch failure (bad endpoint config, no such view)."""


def fleet_key(name: str) -> str:
    """The fleet-merge key for a series name: the ``<pipeline>:``
    prefix is stripped (replica pipeline names differ by construction)
    unless the head names a deployment-shaped series (``serving:``,
    ``fabric:``)."""
    head, sep, rest = name.partition(":")
    if sep and rest and head not in _KEEP_HEADS:
        return rest
    return name


class _ReplicaScrape:
    """Latest scraped state of one replica's control endpoint. The
    tick thread fetches with no lock held, then PUBLISHES plane +
    health fields under the owning view's lock (one generation at a
    time — a reader can never see tick N's profile beside tick N-1's
    memory); readers snapshot frozen copies via ``_state_rows``.
    ``flight_cursor``/``pid`` are tick-thread-private scrape cursors."""

    __slots__ = ("rid", "endpoint", "ok", "last_ok_t", "last_attempt_t",
                 "scrapes", "errors", "last_error", "profile_raw",
                 "profile_snap", "memory", "quality_cells", "quality_snap",
                 "metrics_text", "flight_cursor", "pid")

    def __init__(self, rid: str, endpoint: str):
        self.rid = rid
        self.endpoint = endpoint
        self.ok = False
        self.last_ok_t = 0.0          # monotonic, 0 = never
        self.last_attempt_t = 0.0
        self.scrapes = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        self.profile_raw: Optional[dict] = None   # export_state() shape
        self.profile_snap: Optional[dict] = None  # snapshot() shape
        self.memory: Optional[dict] = None
        self.quality_cells: Optional[dict] = None
        self.quality_snap: Optional[dict] = None
        self.metrics_text: str = ""
        self.flight_cursor: Optional[int] = None
        self.pid: Optional[int] = None


class FleetView:
    """The parent-side fleet join (see module docstring).

    ``source`` is anything with ``control_endpoints() -> {replica_id:
    url_or_None}`` (``ProcReplicaSet``, ``ReplicaPool``); ``endpoints``
    is a static ``{replica_id: url}`` dict (or a callable returning
    one) for hand-wired fleets and tests. Both compose; membership is
    re-discovered every tick, so scale-out/in and respawns onto new
    ports are followed automatically.

    Threading contract (docs/concurrency.md): ``FleetView._lock`` is a
    LEAF guarding the scraped-state table and the merged flight ring —
    never held across an HTTP call. All scraping happens on the single
    ``fleet:<name>`` tick thread (or a test calling :meth:`tick`
    directly — never both at once). Readers (snapshot/merge/window
    queries) are safe from any thread.
    """

    def __init__(self, name: str, source=None,
                 endpoints=None, *,
                 tick_s: float = 1.0,
                 stale_after_s: float = 5.0,
                 scrape_timeout_s: float = 2.0,
                 flight_capacity: int = 2048,
                 include_parent_flight: bool = True,
                 flight_pull: int = 256,
                 profiler=None):
        if tick_s <= 0:
            raise FleetError(f"tick_s={tick_s} must be > 0")
        if stale_after_s <= 0:
            raise FleetError(f"stale_after_s={stale_after_s} must be > 0")
        if source is None and endpoints is None:
            raise FleetError("FleetView needs a source (ProcReplicaSet/"
                             "ReplicaPool) and/or static endpoints")
        self.name = name
        self.source = source
        self._endpoints = endpoints
        self.tick_s = tick_s
        self.stale_after_s = stale_after_s
        self.scrape_timeout_s = scrape_timeout_s
        self.flight_pull = flight_pull
        self.include_parent_flight = include_parent_flight
        from .profile import default_profiler

        self._local = profiler if profiler is not None else default_profiler
        self._lock = named_lock(f"FleetView._lock:{name}")
        self._states: Dict[str, _ReplicaScrape] = {}   # guarded-by: _lock
        self._flight_ring: "collections.deque[dict]" = collections.deque(
            maxlen=flight_capacity)                    # guarded-by: _lock
        self._fleet_seq = itertools.count()
        self._local_flight_cursor: Optional[int] = None
        self._ticks = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _fleets.add(self)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetView":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        # re-join the scrape surfaces on restart (stop() discards;
        # same stance as Autoscaler.start())
        _fleets.add(self)
        self._thread = threading.Thread(target=self._loop,
                                        name=f"fleet:{self.name}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(10.0, self.scrape_timeout_s * 6))
            self._thread = None
        # leave the scrape surfaces NOW, not at GC (same stance as
        # obs_metrics.untrack_*)
        _fleets.discard(self)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the scraper must outlive
                # one bad tick (a replica dying mid-scrape is the POINT)
                logger.exception("fleet %s: scrape tick failed", self.name)

    # -- discovery -----------------------------------------------------------
    def _discover(self) -> Dict[str, Optional[str]]:
        out: Dict[str, Optional[str]] = {}
        if self.source is not None:
            eps = getattr(self.source, "control_endpoints", None)
            if eps is not None:
                try:
                    out.update(eps())
                except Exception:  # noqa: BLE001 - source mid-teardown
                    logger.exception("fleet %s: endpoint discovery failed",
                                     self.name)
        static = self._endpoints
        if callable(static):
            static = static()
        if static:
            out.update(static)
        return out

    # -- scraping (tick thread only) ------------------------------------------
    def tick(self) -> dict:
        """One scrape pass over the discovered membership; returns a
        compact per-replica outcome dict (tests read it)."""
        members = self._discover()
        now = time.monotonic()
        with self._lock:
            # forget replicas that left the membership (scale-in,
            # breaker discard) — their series leave the merged view
            for rid in [r for r in self._states if r not in members]:
                del self._states[rid]
            for rid, url in members.items():
                st = self._states.get(rid)
                if st is None:
                    st = self._states[rid] = _ReplicaScrape(rid, url or "")
                if url:
                    st.endpoint = url
            states = {rid: self._states[rid] for rid in members}
        outcome: Dict[str, str] = {}
        new_events: List[dict] = []
        for rid, url in members.items():
            st = states[rid]
            if not url:
                with self._lock:
                    st.last_attempt_t = now
                    st.ok = False
                    st.last_error = "no control endpoint (replica dead?)"
                outcome[rid] = "no-endpoint"
                continue
            try:
                planes, events = self._scrape_one(st)
            except Exception as e:  # noqa: BLE001 - a dying replica's
                # half-closed socket raises whatever it raises; the
                # snapshot must stay coherent with its last-known data
                with self._lock:
                    st.last_attempt_t = now
                    st.ok = False
                    st.errors += 1
                    st.last_error = f"{type(e).__name__}: {e}"
                outcome[rid] = "error"
            else:
                new_events.extend(events)
                # publish the whole scrape generation atomically: a
                # reader must never see this tick's profile beside the
                # previous tick's memory, or ok=True with a stale age
                with self._lock:
                    st.last_attempt_t = now
                    for field, value in planes.items():
                        setattr(st, field, value)
                    st.ok = True
                    st.last_ok_t = time.monotonic()
                    st.scrapes += 1
                    st.last_error = None
                outcome[rid] = "ok"
        if self.include_parent_flight:
            # cursored pulls are UNCAPPED: dump keeps the newest N
            # AFTER the cursor filter, so a cap smaller than a burst
            # would drop its oldest events and the advanced cursor
            # would skip them forever; flight_pull only bounds the
            # FIRST (cursorless) backlog pull
            local = obs_flight.dump(
                after=self._local_flight_cursor,
                last=(self.flight_pull if self._local_flight_cursor is None
                      else None))
            if local:
                self._local_flight_cursor = local[-1]["seq"]
                for ev in local:
                    new_events.append({**ev, "replica": PARENT_REPLICA})
        if new_events:
            # interleave by wall timestamp BEFORE assigning fleet seqs,
            # so the merged stream's cursor order is its time order
            new_events.sort(key=lambda ev: ev.get("time", 0.0))
            with self._lock:
                for ev in new_events:
                    ev["fleet_seq"] = next(self._fleet_seq)
                    self._flight_ring.append(ev)
        self._ticks += 1
        return outcome

    def _client(self, endpoint: str):
        from ..service.api import ControlClient

        # retries=0: the tick cadence IS the retry loop, and a wedged
        # endpoint must cost one timeout per tick, not three
        return ControlClient(endpoint, timeout=self.scrape_timeout_s,
                             retries=0)

    def _scrape_one(self, st: _ReplicaScrape
                    ) -> Tuple[Dict[str, object], List[dict]]:
        """All planes of one replica, fetched with NO lock held; raises
        on the CORE scrape (profile) failing, tolerates the satellites.
        Returns (plane-field updates, tagged flight events) for tick()
        to publish under the view's lock; only the tick-thread-private
        flight cursor (``flight_cursor``/``pid``) advances in place. A
        satellite that fails is absent from the updates, so its
        last-known data keeps merging."""
        client = self._client(st.endpoint)
        prof = client.profile(raw=True)
        planes: Dict[str, object] = {
            "profile_raw": prof.get("raw") or {},
            "profile_snap": prof.get("profile") or {},
        }
        try:
            planes["memory"] = client.memory().get("memory")
        except Exception:  # noqa: BLE001 - optional plane
            pass
        try:
            qual = client.quality(raw=True)
            planes["quality_cells"] = qual.get("cells") or {}
            planes["quality_snap"] = qual.get("quality") or {}
        except Exception:  # noqa: BLE001 - optional plane
            pass
        try:
            planes["metrics_text"] = client.metrics_text()
        except Exception:  # noqa: BLE001 - optional plane
            pass
        events: List[dict] = []
        try:
            # cursored pulls fetch uncapped (same stance as the local
            # dump in tick() and obs flight --follow): after= already
            # bounds the reply to new events, and a cap below a burst
            # would lose its oldest events to the advancing cursor
            flight = client.flight(
                last=(self.flight_pull if st.flight_cursor is None
                      else 1_000_000),
                after=st.flight_cursor)
            pid = flight.get("pid")
            if pid is not None:
                if st.pid is not None and pid != st.pid:
                    # the ring identity respawned onto a NEW process:
                    # its recorder (and seq space) restarted at 0, so a
                    # cursor from the old epoch would silently filter
                    # out every post-respawn event — exactly the
                    # postmortem events this stream exists to surface
                    st.flight_cursor = None
                    flight = client.flight(last=self.flight_pull)
                st.pid = pid
            for ev in flight.get("events", []):
                st.flight_cursor = max(st.flight_cursor or -1, ev["seq"])
                events.append({**ev, "replica": st.rid})
        except Exception:  # noqa: BLE001 - optional plane
            pass
        return planes, events

    # -- reading: membership ---------------------------------------------------
    def _state_rows(self) -> List[_ReplicaScrape]:
        # frozen per-replica copies: a reader walks one consistent
        # scrape generation per replica while the tick thread publishes
        # the next one (scraped plane dicts are replaced wholesale,
        # never mutated in place, so shallow copies suffice)
        with self._lock:
            return [copy.copy(st) for st in self._states.values()]

    def replicas(self) -> List[dict]:
        """Per-replica scrape health (age/staleness) — the bounded-
        staleness contract: ``stale`` is True once the last successful
        scrape is older than ``stale_after_s`` (the replica's data is
        still merged — windowed queries age it out by wall time)."""
        now = time.monotonic()
        out = []
        for st in self._state_rows():
            age = (now - st.last_ok_t) if st.last_ok_t else None
            out.append({
                "replica": st.rid,
                "endpoint": st.endpoint,
                "ok": st.ok,
                "stale": age is None or age > self.stale_after_s,
                "age_s": None if age is None else round(age, 3),
                "scrapes": st.scrapes,
                "errors": st.errors,
                "last_error": st.last_error,
                "wire": _wire_summary(st.metrics_text),
            })
        return out

    def metric(self, rid: str, name: str, **labels) -> Optional[float]:
        """One Prometheus sample out of a replica's last ``/metrics``
        scrape (obs/promtext.py); None when absent/never scraped."""
        with self._lock:
            st = self._states.get(rid)
            text = st.metrics_text if st is not None else ""
        return promtext.sample(text, name, **labels) if text else None

    # -- reading: merged planes ------------------------------------------------
    def merged_durations(self) -> Dict[str, Dict[str, dict]]:
        """{scope: {fleet-key: {count, total_s, digest, replicas}}} —
        duration digests merged bucket-wise EXACTLY across replicas
        (fleet p50/p99 == pooled)."""
        out: Dict[str, Dict[str, dict]] = {}
        for st in self._state_rows():
            raw = st.profile_raw or {}
            for scope, names in (raw.get("durations") or {}).items():
                scope_out = out.setdefault(scope, {})
                for name, entry in names.items():
                    key = (fleet_key(name) if scope in _PIPELINE_SCOPES
                           else name)
                    digest = QuantileDigest.from_dict(entry["digest"])
                    cell = scope_out.get(key)
                    if cell is None:
                        scope_out[key] = {
                            "count": int(entry["count"]),
                            "total_s": float(entry["total_s"]),
                            "digest": digest,
                            "replicas": [st.rid],
                        }
                    else:
                        cell["count"] += int(entry["count"])
                        cell["total_s"] += float(entry["total_s"])
                        cell["digest"].merge(digest)
                        cell["replicas"].append(st.rid)
        return out

    def request_series_names(self) -> List[str]:
        names = set()
        for st in self._state_rows():
            names.update((st.profile_raw or {}).get("requests", {}))
        return sorted(names)

    def request_total(self, series: str) -> Optional[QuantileDigest]:
        """The fleet-merged CUMULATIVE digest of one request series —
        bit-for-bit the digest of the pooled samples (the exactness
        property the fleet gauges and tests assert). None when no
        replica exports the series."""
        merged: Optional[QuantileDigest] = None
        for st in self._state_rows():
            req = (st.profile_raw or {}).get("requests", {}).get(series)
            if not req:
                continue
            digest = QuantileDigest.from_dict(req["total"])
            if merged is None:
                merged = digest
            else:
                merged.merge(digest)
        return merged

    def _request_aggregate(self) -> Dict[str, dict]:
        """ONE ``_state_rows()`` walk → every request series' fleet
        rollup: ``{series: {"digest": exact merged QuantileDigest,
        "errors": int, "replicas": [(rid, p99_seconds), ...]}}``.
        ``snapshot()`` and the gauge collector consume this instead of
        re-walking (and re-locking) the scrape state once per series."""
        agg: Dict[str, dict] = {}
        for st in self._state_rows():
            for series, req in (st.profile_raw or {}).get(
                    "requests", {}).items():
                if not req:
                    continue
                digest = QuantileDigest.from_dict(req["total"])
                cell = agg.setdefault(
                    series, {"digest": None, "errors": 0, "replicas": []})
                cell["errors"] += int(req.get("errors", 0))
                cell["replicas"].append((st.rid, digest.quantile(0.99)))
                if cell["digest"] is None:
                    cell["digest"] = digest
                else:
                    cell["digest"].merge(digest)
        return agg

    def request_window(self, series: str, seconds: float,
                       now: Optional[float] = None
                       ) -> Tuple[QuantileDigest, int, int]:
        """(merged digest, ok, err) of one request series over the
        trailing window, across EVERY replica — the profiler-compatible
        read the SLO engine and autoscaler consume
        (``profiler.request_window`` signature). Replica cells are
        wall-clock aligned via each export's monotonic→wall offset, so
        a replica whose process (and monotonic epoch) restarted still
        lands in the right window. Falls back to the LOCAL profiler
        when no replica exports the series (availability/memory/quality
        self-sampled series live parent-side)."""
        t = time.monotonic() if now is None else now
        wall_hi = t + obs_context.mono_to_wall_offset()
        wall_lo = wall_hi - seconds
        merged: Optional[QuantileDigest] = None
        ok = err = 0
        found = False
        for st in self._state_rows():
            raw = st.profile_raw or {}
            req = raw.get("requests", {}).get(series)
            if not req:
                continue
            found = True
            res = float(req.get("resolution_s", 1.0))
            offset = float(raw.get("mono_to_wall", 0.0))
            for cell in req.get("cells", []):
                wall_t = float(cell["epoch"]) * res + offset
                # one-cell tolerance on both edges: cell timestamps are
                # bucket starts and the offset is sampled per scrape
                if wall_lo - res <= wall_t <= wall_hi + res:
                    digest = QuantileDigest.from_dict(cell["digest"])
                    if merged is None:
                        merged = digest
                    else:
                        merged.merge(digest)
                    ok += int(cell.get("ok", 0))
                    err += int(cell.get("err", 0))
        if not found:
            return self._local.request_window(series, seconds, now=now)
        if merged is None:
            merged = QuantileDigest()
        return merged, ok, err

    def record_request(self, series: str, seconds: float, ok: bool = True,
                       now: Optional[float] = None) -> None:
        """Profiler-facade write half: self-sampled SLO series
        (availability / memory / quality kinds) record into the LOCAL
        profiler — ``SloEngine(profiler=fleet)`` needs both halves."""
        self._local.record_request(series, seconds, ok=ok, now=now)

    def merged_memory(self) -> dict:
        """Max-watermark merge of the replicas' memory planes: stage
        estimates per fleet key, device rows per device id — merged
        replicas report the WORST observed footprint, never a sum
        (artifact ``memory`` semantics)."""
        from . import memory as obs_memory

        stages: Dict[str, dict] = {}
        devices: Dict[str, dict] = {}
        for st in self._state_rows():
            mem = st.memory or {}
            for name, cell in (mem.get("stages") or {}).items():
                key = fleet_key(name)
                mine = stages.get(key)
                if mine is None:
                    stages[key] = dict(cell)
                    continue
                for field, value in cell.items():
                    if field == "kind":
                        mine.setdefault("kind", value)
                    elif isinstance(value, (int, float)) and \
                            value > (mine.get(field) or 0):
                        mine[field] = value
                if any(f in mine for f in obs_memory.FIELDS):
                    mine["total_bytes"] = sum(
                        int(mine.get(f, 0) or 0) for f in obs_memory.FIELDS)
            for row in (mem.get("devices") or []):
                dev = row.get("device", "?")
                mine = devices.get(dev)
                if mine is None:
                    devices[dev] = dict(row)
                    continue
                for field, value in row.items():
                    if isinstance(value, (int, float)) and \
                            value > (mine.get(field) or 0):
                        mine[field] = value
        return {"stages": stages,
                "devices": [devices[d] for d in sorted(devices)]}

    def merged_quality(self) -> Dict[str, dict]:
        """Additive merge of the replicas' tensor-health cells per
        fleet key (counts sum, extremes extend, histograms merge
        exactly — :func:`~.quality.merge_cells`)."""
        from . import quality as obs_quality

        out: Dict[str, dict] = {}
        for st in self._state_rows():
            for name, cell in (st.quality_cells or {}).items():
                key = fleet_key(name)
                mine = out.get(key)
                if mine is None:
                    out[key] = dict(cell)
                else:
                    obs_quality.merge_cells(mine, cell)
        return out

    # -- reading: merged flight ------------------------------------------------
    def flight(self, last: Optional[int] = 256,
               category: Optional[str] = None,
               pipeline: Optional[str] = None,
               after: Optional[int] = None) -> List[dict]:
        """The fleet-merged flight stream: replica + parent events
        interleaved by timestamp, each tagged ``replica`` and stamped
        ``fleet_seq`` (the ``--follow`` cursor over the MERGED
        stream)."""
        with self._lock:
            events = list(self._flight_ring)
        out = []
        for ev in events:
            if after is not None and ev["fleet_seq"] <= after:
                continue
            if category is not None and ev.get("kind") != category:
                continue
            if pipeline is not None and ev.get("pipeline") != pipeline:
                continue
            out.append(ev)
        if last is not None:
            out = out[-last:]
        return out

    # -- trace stitching --------------------------------------------------------
    def fetch_spans(self, trace_id: Optional[str] = None,
                    include_local: bool = True) -> List[Tuple[str, dict]]:
        """(label, export) batches: the parent's own spans plus every
        reachable replica's ``GET /spans`` export (a replica that does
        not answer is skipped — stitching is a best-effort postmortem
        read, not a gate)."""
        batches: List[Tuple[str, dict]] = []
        if include_local:
            batches.append((PARENT_REPLICA,
                            obs_context.export_spans(trace_id)))
        for st in self._state_rows():
            if not st.endpoint:
                continue
            try:
                batches.append(
                    (st.rid, self._client(st.endpoint).spans(trace=trace_id)))
            except Exception:  # noqa: BLE001 - unreachable replica
                continue
        return batches

    def stitch_trace(self, trace_id: str,
                     path: Optional[str] = None) -> dict:
        """ONE Perfetto/chrome-trace document for a distributed trace:
        parent spans and every replica's spans for ``trace_id``, placed
        on one wall-clock timeline (each export carries its process's
        monotonic→wall offset), with per-process ``pid`` lanes named
        after the replica id. The cross-process acceptance property:
        root → attempt → the subprocess's serving/fused spans all share
        the SAME ``trace_id`` in the one document."""
        batches = self.fetch_spans(trace_id)
        rows: List[Tuple[str, int, dict]] = []
        for label, batch in batches:
            pid = int(batch.get("pid") or 0)
            for sp in batch.get("spans", []):
                rows.append((label, pid, sp))
        if not rows:
            doc = {"traceEvents": []}
        else:
            t0 = min(sp.get("start_wall_s", 0.0) for _l, _p, sp in rows)
            events = []
            seen_pids: Dict[int, str] = {}
            for label, pid, sp in rows:
                seen_pids.setdefault(pid, label)
                events.append({
                    "name": sp["name"],
                    "cat": sp["kind"],
                    "ph": "X",
                    "ts": (sp.get("start_wall_s", t0) - t0) * 1e6,
                    "dur": sp.get("dur_s", 0.0) * 1e6,
                    "pid": pid,
                    "tid": sp.get("tid", 0),
                    # span attrs spread FIRST: the stitch's own keys
                    # (replica lane, ids) must win a collision — a
                    # fabric attempt span carries attrs={"replica": ...}
                    # that would otherwise shadow the exporting lane
                    "args": {
                        **(sp.get("attrs") or {}),
                        "trace_id": sp["trace_id"],
                        "span_id": sp["span_id"],
                        "parent_span_id": sp.get("parent_span_id"),
                        "status": sp.get("status", "ok"),
                        "links": sp.get("links", []),
                        "replica": label,
                    },
                })
            for pid, label in seen_pids.items():
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": f"{self.name}:{label}"}})
            doc = {"traceEvents": events}
        if path:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc

    # -- snapshot ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``GET /fleet`` document: membership health + every
        merged plane rendered JSON-friendly."""
        durations = {
            scope: {
                name: {
                    "count": cell["count"],
                    "total_s": round(cell["total_s"], 6),
                    "p50_ms": cell["digest"].quantile(0.5) * 1e3,
                    "p99_ms": cell["digest"].quantile(0.99) * 1e3,
                    "replicas": len(cell["replicas"]),
                }
                for name, cell in sorted(names.items())
            }
            for scope, names in self.merged_durations().items()
        }
        requests = {}
        for series, cell in sorted(self._request_aggregate().items()):
            digest = cell["digest"]
            requests[series] = {
                "count": digest.count,
                "errors": cell["errors"],
                "p50_ms": digest.quantile(0.5) * 1e3,
                "p99_ms": digest.quantile(0.99) * 1e3,
            }
        quality = {}
        from .quality import TensorHealth

        for key, cell in sorted(self.merged_quality().items()):
            health = TensorHealth.from_cell(cell)
            quality[key] = {"kind": cell.get("kind", "edge"),
                            **health.snapshot()}
        with self._lock:
            buffered = len(self._flight_ring)
        return {
            "name": self.name,
            "tick_s": self.tick_s,
            "stale_after_s": self.stale_after_s,
            "ticks": self._ticks,
            "replicas": self.replicas(),
            "profile": {"durations": durations, "requests": requests},
            "memory": self.merged_memory(),
            "quality": quality,
            "flight_buffered": buffered,
        }


# ---------------------------------------------------------------------------
# module registry + GET /fleet + metrics collector + obs top section
# ---------------------------------------------------------------------------

_fleets: "weakref.WeakSet[FleetView]" = weakref.WeakSet()


def views() -> List[FleetView]:
    return list(_fleets)


def view(name: Optional[str] = None) -> Optional[FleetView]:
    """The named live view (or, when ``name`` is None, the live view
    with the lexicographically-smallest name — WeakSet iteration order
    is arbitrary, and a follow client's ``fleet_seq`` cursor must hit
    the SAME view on every poll or it filters against the wrong seq
    space)."""
    live = views()
    if name is None:
        return min(live, key=lambda v: v.name) if live else None
    for v in live:
        if v.name == name:
            return v
    return None


def snapshot_all() -> List[dict]:
    """Snapshot across every live fleet view (``GET /fleet``, the CLI's
    ``obs fleet`` verb, ``obs top``'s FLEET section)."""
    return [v.snapshot() for v in views()]


def _collect_fleet(reg: obs_metrics.Registry) -> None:
    replicas_g = reg.gauge("nns_fleet_replicas",
                           "replicas in the fleet view's membership",
                           ("fleet",))
    stale_g = reg.gauge("nns_fleet_replicas_stale",
                        "replicas whose last good scrape is older than "
                        "the staleness bound", ("fleet",))
    up = reg.gauge("nns_fleet_replica_up",
                   "1 = last scrape succeeded and is fresh",
                   ("fleet", "replica"))
    age = reg.gauge("nns_fleet_scrape_age_seconds",
                    "age of the replica's last good scrape",
                    ("fleet", "replica"))
    scrapes = reg.counter("nns_fleet_scrapes_total",
                          "successful control-plane scrapes",
                          ("fleet", "replica"))
    errors = reg.counter("nns_fleet_scrape_errors_total",
                         "failed control-plane scrapes",
                         ("fleet", "replica"))
    req_p99 = reg.gauge("nns_fleet_request_p99_seconds",
                        "fleet-merged request p99 (exact pooled digest)",
                        ("fleet", "series"))
    # GAUGES, not counters: the merged value is a sum over the
    # replicas' live exports, and a replica restart (recorder wiped) or
    # scale-in makes it DECREASE while nonzero — which rate() would
    # misread as a counter reset and report as a huge spurious spike
    req_count = reg.gauge("nns_fleet_request_count",
                          "fleet-merged request count per series "
                          "(sum over live replica exports)",
                          ("fleet", "series"))
    req_err = reg.gauge("nns_fleet_request_errors",
                        "fleet-merged request errors per series "
                        "(sum over live replica exports)",
                        ("fleet", "series"))
    r_p99 = reg.gauge("nns_fleet_replica_request_p99_seconds",
                      "per-replica request p99 per series",
                      ("fleet", "replica", "series"))
    for inst in (replicas_g, stale_g, up, age, scrapes, errors, req_p99,
                 req_count, req_err, r_p99):
        inst.clear()
    for v in views():
        rows = v.replicas()
        replicas_g.set(len(rows), fleet=v.name)
        stale_g.set(sum(1 for r in rows if r["stale"]), fleet=v.name)
        for r in rows:
            up.set(0.0 if r["stale"] or not r["ok"] else 1.0,
                   fleet=v.name, replica=r["replica"])
            if r["age_s"] is not None:
                age.set(r["age_s"], fleet=v.name, replica=r["replica"])
            scrapes.set_total(r["scrapes"], fleet=v.name,
                              replica=r["replica"])
            errors.set_total(r["errors"], fleet=v.name,
                             replica=r["replica"])
        for series, cell in v._request_aggregate().items():
            total = cell["digest"]
            req_p99.set(total.quantile(0.99), fleet=v.name, series=series)
            req_count.set(total.count, fleet=v.name, series=series)
            for rid, p99 in cell["replicas"]:
                r_p99.set(p99, fleet=v.name, replica=rid, series=series)
            req_err.set(cell["errors"], fleet=v.name, series=series)


obs_metrics.register_collector("fleet", _collect_fleet)


def _wire_summary(metrics_text: str) -> Optional[str]:
    """Condense a replica's ``nns_wire_*`` samples (last ``/metrics``
    scrape) into one label: ``"binary+shm"``, ``"binary"``, ``"json"``,
    a comma list when connections are mixed, None before any handshake.
    This is how a replica silently stuck on the JSON fallback shows in
    ``obs fleet`` / the FLEET section of ``obs top``."""
    if not metrics_text:
        return None
    formats = sorted(
        {labels.get("format", "?")
         for name, labels, value in promtext.parse_samples(metrics_text)
         if name == "nns_wire_connections" and value > 0})
    if not formats:
        return None
    shm = promtext.sample(metrics_text, "nns_shm_events_total",
                          event="slot_writes")
    tag = ",".join(formats)
    return tag + "+shm" if shm else tag


def render_section(fleet_snaps: List[dict]) -> List[str]:
    """The FLEET section of ``obs top`` (appended by
    ``profile.render_top`` when fleet snapshots are supplied)."""
    lines: List[str] = []
    for snap in fleet_snaps or []:
        lines.append("")
        rows = snap.get("replicas", [])
        stale = sum(1 for r in rows if r.get("stale"))
        lines.append(f"FLEET [{snap.get('name', '?')}] "
                     f"{len(rows)} replica(s), {stale} stale "
                     f"(tick {snap.get('tick_s', 0):g}s, "
                     f"stale after {snap.get('stale_after_s', 0):g}s)")
        lines.append(f"  {'replica':<28} {'state':>7} {'age_s':>7} "
                     f"{'scrapes':>8} {'errors':>7} {'wire':>11}")
        for r in rows:
            state = ("STALE" if r.get("stale")
                     else "ok" if r.get("ok") else "error")
            age_s = r.get("age_s")
            lines.append(
                f"  {r['replica']:<28} {state:>7} "
                f"{'—' if age_s is None else f'{age_s:.1f}':>7} "
                f"{r.get('scrapes', 0):>8d} {r.get('errors', 0):>7d} "
                f"{r.get('wire') or '—':>11}")
        requests = snap.get("profile", {}).get("requests", {})
        if requests:
            lines.append(f"  {'merged series':<28} {'p50ms':>9} "
                         f"{'p99ms':>9} {'n':>8} {'err':>6}")
            for name, s in sorted(requests.items()):
                lines.append(
                    f"  {name:<28} {s['p50_ms']:>9.2f} {s['p99_ms']:>9.2f} "
                    f"{s['count']:>8d} {s['errors']:>6d}")
    return lines
