"""Resilient distributed service fabric: replica pools + failover (L7).

Reference analog: "among-device AI" — NNStreamer's distribution story is
offloading pipeline stages to remote devices over tensor_query/edge
(arxiv 1901.04985, 2101.06371). This module scales that shape up from
"one client, one server, reconnect on loss" to what serving millions of
users needs: N service replicas register behind ONE logical name and the
pool routes, retries, hedges, evicts, and readmits so a single replica
death is invisible to callers.

The pieces
==========

:class:`ReplicaPool`
    The routing core. Replicas come from static endpoint lists
    (:meth:`~ReplicaPool.add_endpoint`), MQTT-hybrid advertisements
    (:meth:`~ReplicaPool.add_discovered`, re-resolved through
    ``query/hybrid.py`` on every readmission probe, so a replica that
    came back on a NEW port is re-found), or in-process supervised
    services (:class:`ServiceFabric`). Per request:

    * **consistent-hash routing with bounded-load spill** — the request
      key hashes onto a vnode ring; the owning replica takes it unless
      its in-flight count exceeds ``load_factor ×`` the fair share, in
      which case the request spills to the next replica on the ring
      (classic bounded-load consistent hashing: sticky keys, no hot
      replica collapse);
    * **deadline-propagated timeouts** — one deadline covers connect,
      retries, and hedges; the remaining budget rides each frame's meta
      (``meta["fabric"]["deadline_s"]``) so a server-side scheduler can
      shed what cannot finish in time;
    * **idempotency-keyed retries** — a failed attempt retries on a
      DIFFERENT replica (the failed one is excluded) while budget
      remains; keyless requests retry too when the pool is declared
      ``assume_idempotent`` (pure inference is — default true);
    * **hedging** — with ``hedge_after_s`` set, an attempt that has not
      answered within the hedge delay fires a duplicate on another
      replica and the first answer wins (tail-latency insurance against
      a slow replica).

    Health: every attempt outcome feeds a per-replica EWMA score;
    ``fail_threshold`` consecutive failures (or a collapsed score, or an
    attached service reporting not-ready) EVICTS the replica into
    QUARANTINE. The health thread probes quarantined replicas after an
    exponential backoff (full TCP + caps handshake, address re-resolved)
    and READMITS on success — eviction is never permanent, readmission
    is never un-probed.

:class:`ServiceFabric`
    N supervised :mod:`.manager` services (one query-server pipeline
    each) behind one pool, plus the cross-replica rollout verbs:
    :meth:`~ServiceFabric.rolling_swap` drains one replica (no new
    routes, in-flight flushes), hot-swaps only its filters
    (``ModelSlots.swap(services=[...])``), readmits it, then moves to
    the next — the whole roll costs zero request errors.
    :meth:`~ServiceFabric.canary` flips ONE replica to the candidate
    version and routes ``fraction`` of keys to it; promote rolls the
    rest, cancel flips it back.

Chaos: ``tools/chaos_torch.py`` + :data:`~..elements.fault.net_chaos`
exercise every failover path here (replica kill, connection kill, delay,
partition, rolling swap, load ramp, process-replica and shm-peer kills,
wire corruption, all under traffic) with a zero-request-errors gate;
``tests/test_torch_chaos_harness.py`` runs its smoke set under the port's
``NNS_TSAN=1`` and ``NNS_LEAKCHECK=1``.

Lock contracts (docs/concurrency.md): ``ReplicaPool._lock`` guards
membership/ring/stats and is never held across network I/O, sleeps, or
``_Link`` operations; ``_Link._lock`` guards only the connection
free-list. Order: ``ReplicaPool._lock`` is a leaf — nothing else is
acquired under it.
"""
from __future__ import annotations

import bisect
import enum
import hashlib
import itertools
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.sanitizer import named_condition, named_lock
from ..core import Buffer, parse_caps_string
from ..obs import context as obs_context
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..utils.log import logger
from ..utils.threads import ThreadRegistry


class FabricError(RuntimeError):
    pass


class NoReplicaAvailable(FabricError):
    """No ACTIVE replica could take the request within its deadline."""


class RequestFailed(FabricError):
    """Every attempt (retries and hedges included) failed within the
    request's deadline; the last per-attempt error is chained."""


class ReplicaState(enum.Enum):
    ACTIVE = "active"
    QUARANTINED = "quarantined"   # evicted; readmission probe pending
    DRAINING = "draining"         # rolling swap: no new routes


# EWMA smoothing for the health score (higher alpha = faster forgetting)
_SCORE_ALPHA = 0.3
_SCORE_MIN_SAMPLES = 8
_SCORE_FLOOR = 0.5


class Replica:
    """One endpoint behind the pool. ``resolver`` returns the CURRENT
    (host, port) — static endpoints return a constant, hybrid replicas
    re-discover through the MQTT broker, service replicas ask their
    live pipeline — so readmission survives a replica that came back
    somewhere else. All mutable fields are guarded by the owning pool's
    ``_lock``."""

    def __init__(self, replica_id: str,
                 resolver: Callable[[], Tuple[str, int]],
                 service=None, control=None):
        self.id = replica_id
        self.resolver = resolver
        self.service = service
        # optional control-plane endpoint behind the replica: a URL
        # string or a zero-arg callable returning the CURRENT one (or
        # None while the replica is down) — subprocess/remote replicas
        # advertise theirs so the fleet scraper (obs/fleet.py) can
        # discover every replica's obs planes straight off the pool
        self.control = control
        self.state = ReplicaState.ACTIVE       # guarded-by: ReplicaPool._lock
        self.score = 1.0                       # guarded-by: ReplicaPool._lock
        self.samples = 0                       # guarded-by: ReplicaPool._lock
        self.consecutive_failures = 0          # guarded-by: ReplicaPool._lock
        self.inflight = 0                      # guarded-by: ReplicaPool._lock
        self.quarantined_until = 0.0           # guarded-by: ReplicaPool._lock
        self.backoff_s = 0.0                   # guarded-by: ReplicaPool._lock
        self.stats = {"requests": 0, "failures": 0, "evictions": 0,
                      "readmissions": 0}       # guarded-by: ReplicaPool._lock
        self.link: Optional[_Link] = None      # set once at add time
        # the data plane the LAST successful dial negotiated with this
        # replica ("binary"/"json", "+shm" when the same-host ring is
        # on; None until first dial) — surfaced in pool snapshots and
        # the obs fleet view. Written by _Link._dial without the pool
        # lock: a stale read only mislabels a replica mid-redial.
        self.wire_format: Optional[str] = None

    def snapshot_locked(self) -> dict:
        # caller holds the pool lock
        return {"id": self.id, "state": self.state.value,
                "score": round(self.score, 3), "inflight": self.inflight,
                "consecutive_failures": self.consecutive_failures,
                "wire": self.wire_format,
                **self.stats}


class _Link:
    """Per-replica connection pool with an EXCLUSIVE-connection-per-call
    discipline: each call checks a connection out, owns its FIFO, and
    returns it only after a clean answer — so answers can never mis-match
    across concurrent requests. A timed-out or errored connection is
    CLOSED, not reused (its FIFO may hold a late answer)."""

    def __init__(self, pool: "ReplicaPool", replica: Replica):
        self._pool = pool
        self._replica = replica
        self._lock = named_lock(f"FabricLink._lock:{replica.id}")
        self._free: List[object] = []    # idle QueryClients  guarded-by: _lock
        self._issued: List[object] = []  # checked-out clients guarded-by: _lock

    def _dial(self, deadline: float):
        from ..query.client import QueryClient

        host, port = self._replica.resolver()
        budget = max(0.05, min(self._pool.connect_timeout,
                               deadline - time.monotonic()))
        client = QueryClient(host, port, timeout=budget,
                             wire=self._pool.wire, shm=self._pool.shm)
        client.connect(self._pool.caps)
        self._replica.wire_format = (
            client.wire_format + ("+shm" if client.shm_active else ""))
        return client

    def call(self, buf: Buffer, deadline: float) -> Buffer:
        """Send ``buf``, wait for its answer. Raises TimeoutError /
        ConnectionError / RemoteError; the connection is recycled only
        on success."""
        with self._lock:
            client = self._free.pop() if self._free else None
        if client is None:
            client = self._dial(deadline)
        from ..query.client import RemoteError

        with self._lock:
            self._issued.append(client)
        ok = False
        try:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("deadline exhausted before send")
            out = client.request(buf, timeout=remaining)
            ok = True
            return out
        except RemoteError:
            # the typed error WAS the answer: the FIFO is in sync, so
            # the connection is safe to recycle — closing it would make
            # overload (when servers shed most) also pay a redial per
            # shed request
            ok = True
            raise
        finally:
            with self._lock:
                if client in self._issued:
                    self._issued.remove(client)
                if ok:
                    self._free.append(client)
            if not ok:
                client.close()

    def probe(self, timeout: float = 1.0) -> None:
        """Full connect + caps handshake against the replica's CURRENT
        address (readmission must prove the server actually serves)."""
        client = self._dial(time.monotonic() + timeout)
        client.close()

    def close_all(self) -> None:
        """Close idle AND in-flight connections (eviction: blocked
        waiters see DISCONNECTED promptly instead of riding out their
        full timeout on a dead replica)."""
        with self._lock:
            clients = self._free + self._issued
            self._free = []
            self._issued = []
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class ReplicaPool:
    """N replicas behind one logical service name. See the module
    docstring for routing/health semantics."""

    def __init__(self, name: str, caps: str, *,
                 load_factor: float = 1.25,
                 vnodes: int = 32,
                 max_attempts: int = 3,
                 hedge_after_s: Optional[float] = None,
                 assume_idempotent: bool = True,
                 fail_threshold: int = 2,
                 quarantine_base_s: float = 0.25,
                 quarantine_max_s: float = 5.0,
                 connect_timeout: float = 2.0,
                 health_poll_s: float = 0.1,
                 wire: str = "auto",
                 shm: bool = True):
        if load_factor < 1.0:
            raise ValueError(f"load_factor {load_factor} must be >= 1")
        self.name = name
        self.caps = parse_caps_string(caps) if isinstance(caps, str) else caps
        self.load_factor = load_factor
        self.vnodes = vnodes
        self.max_attempts = max_attempts
        self.hedge_after_s = hedge_after_s
        self.assume_idempotent = assume_idempotent
        self.fail_threshold = fail_threshold
        self.quarantine_base_s = quarantine_base_s
        self.quarantine_max_s = quarantine_max_s
        self.connect_timeout = connect_timeout
        self.health_poll_s = health_poll_s
        # data-plane policy for every link this pool dials: "auto"
        # negotiates the binary wire (and, with shm=True, the same-host
        # shared-memory ring) per connection; "json" forces the legacy
        # NNST frames (transport/frame.py, docs/transport.md)
        self.wire = wire
        self.shm = shm
        self._lock = named_lock(f"ReplicaPool._lock:{name}")
        # readmissions / in-flight completions wake blocked routers
        self._cond = named_condition(f"ReplicaPool._cond:{name}", self._lock)
        self._replicas: Dict[str, Replica] = {}   # guarded-by: _lock
        self._ring: List[Tuple[int, str]] = []    # guarded-by: _lock
        self._points: List[int] = []              # guarded-by: _lock
        self._inflight_total = 0                  # guarded-by: _lock
        self._canary: Optional[Tuple[str, float, str]] = None  # guarded-by: _lock
        # overload shed cutoff (None = disarmed): armed by the autoscaler
        # when the replica set is at its ceiling — requests with
        # priority >= cutoff are refused with a typed OverloadShedError
        # BEFORE they touch the wire (docs/autoscaling.md)
        self._shed_min_priority: Optional[int] = None  # guarded-by: _lock
        self._keyless_seq = itertools.count()
        self.stats = {"requests": 0, "retries": 0, "hedges": 0,
                      "hedge_wins": 0, "request_errors": 0,
                      "evictions": 0, "readmissions": 0,
                      "spills": 0, "shed_overload": 0}  # guarded-by: _lock
        self._threads = ThreadRegistry()
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # join the unified metrics plane: the pool shows up in
        # serving.metrics_snapshot()["fabric"] and at GET /metrics
        obs_metrics.track_pool(self)
        self._latency_hist = obs_metrics.histogram(
            "nns_fabric_request_latency_seconds",
            "end-to-end fabric request latency (retries/hedges included)",
            ("pool",),
            buckets=obs_metrics.Histogram.LATENCY_BUCKETS_REQUEST)

    # -- membership ----------------------------------------------------------
    def add_endpoint(self, host: str, port: int,
                     replica_id: Optional[str] = None,
                     service=None,
                     resolver: Optional[Callable[[], Tuple[str, int]]] = None,
                     control=None) -> Replica:
        """Register a replica at a static address (or with a custom
        ``resolver`` — service replicas pass one that reads the live
        pipeline's bound port, so a restart onto a new ephemeral port is
        transparent). ``control`` optionally names the replica's
        control-plane endpoint (URL or callable) for the fleet scraper
        (:meth:`control_endpoints`)."""
        rid = replica_id or f"{host}:{port}"
        if resolver is None:
            resolver = lambda h=host, p=port: (h, p)  # noqa: E731
        return self._add(Replica(rid, resolver, service=service,
                                 control=control))

    def add_discovered(self, broker_host: str, broker_port: int,
                       topic: str,
                       replica_id: Optional[str] = None,
                       timeout: float = 5.0) -> Replica:
        """Register a replica advertised over MQTT-hybrid discovery. The
        resolver re-queries the broker, so a replica that re-advertised
        from a new address is readmitted THERE, not at its old one."""
        from ..query.hybrid import discover

        def resolve() -> Tuple[str, int]:
            return discover(broker_host, broker_port, topic, timeout)

        resolve()  # fail fast: the topic must be advertised at add time
        return self._add(Replica(replica_id or f"topic:{topic}", resolve))

    def _add(self, replica: Replica) -> Replica:
        replica.link = _Link(self, replica)
        with self._lock:
            if replica.id in self._replicas:
                raise FabricError(
                    f"pool '{self.name}': replica '{replica.id}' already "
                    "registered")
            self._replicas[replica.id] = replica
            self._rebuild_ring_locked()
            self._cond.notify_all()
        logger.info("pool %s: replica %s joined (%d total)", self.name,
                    replica.id, len(self._replicas))
        self._ensure_health_thread()
        return replica

    def remove(self, replica_id: str) -> None:
        with self._lock:
            replica = self._replicas.pop(replica_id, None)
            if replica is not None:
                self._rebuild_ring_locked()
        if replica is not None and replica.link is not None:
            replica.link.close_all()

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def _rebuild_ring_locked(self) -> None:
        ring = []
        for rid in self._replicas:
            for v in range(self.vnodes):
                ring.append((_hash64(f"{rid}#{v}"), rid))
        ring.sort()
        self._ring = ring
        # bisect key list, cached here: rebuilding it per routed request
        # would allocate O(replicas x vnodes) under the hot-path lock
        self._points = [p for p, _ in ring]

    # -- health / lifecycle --------------------------------------------------
    def _ensure_health_thread(self) -> None:
        with self._lock:
            if self._health_thread is not None:
                return
            self._health_stop.clear()
            t = threading.Thread(target=self._health_loop,
                                 name=f"fabric:{self.name}:health",
                                 daemon=True)
            self._health_thread = t
        t.start()

    def close(self) -> None:
        """Stop the health thread, close every link, join workers."""
        self._health_stop.set()
        with self._lock:
            t, self._health_thread = self._health_thread, None
            replicas = list(self._replicas.values())
            self._cond.notify_all()
        if t is not None:
            t.join(timeout=2.0)
        for r in replicas:
            if r.link is not None:
                r.link.close_all()
        self._threads.drain(timeout_per=2.0)

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.health_poll_s):
            try:
                self._health_tick()
            except Exception:  # noqa: BLE001 - the monitor must survive
                logger.exception("pool %s: health tick failed", self.name)

    def _health_tick(self) -> None:
        now = time.monotonic()
        probe_due: List[Replica] = []
        service_check: List[Replica] = []
        with self._lock:
            for r in self._replicas.values():
                if r.state is ReplicaState.QUARANTINED:
                    if now >= r.quarantined_until:
                        probe_due.append(r)
                elif r.state is ReplicaState.ACTIVE and r.service is not None:
                    service_check.append(r)
        # service probes OUTSIDE the pool lock (they take Service._lock):
        # service-backed replicas surface their control-plane verdict
        # (supervisor gave up, user stopped, stall watchdog — anything
        # that leaves the service not READY) without waiting for a
        # request to fail
        for r in service_check:
            if not r.service.readiness():
                self._evict(r, "service not ready "
                               f"(state={r.service.state.value})")
        # probes run OUTSIDE the lock (full TCP handshake each)
        for r in probe_due:
            try:
                r.link.probe(timeout=self.connect_timeout)
                if r.service is not None and not r.service.readiness():
                    # a reachable listener is not a serving replica: a
                    # service mid-restart accepts TCP before it is READY
                    # — readmitting here would flap evict/readmit
                    raise ConnectionError(
                        "service not ready "
                        f"(state={r.service.state.value})")
            except Exception as e:  # noqa: BLE001 - any failure re-arms
                with self._lock:
                    if r.state is not ReplicaState.QUARANTINED:
                        continue
                    r.backoff_s = min(max(r.backoff_s * 2,
                                          self.quarantine_base_s),
                                      self.quarantine_max_s)
                    r.quarantined_until = time.monotonic() + r.backoff_s
                logger.info("pool %s: replica %s readmission probe failed "
                            "(%s); next probe in %.2fs", self.name, r.id,
                            e, r.backoff_s)
                continue
            self._readmit(r)

    def evict(self, replica_id: str, reason: str) -> None:
        """External eviction verdict — e.g. a subprocess replica whose
        PROCESS exited (``procreplica.ProcReplicaSet.reap_dead``): the
        pool must stop routing to it NOW instead of waiting for
        ``fail_threshold`` request corpses. Unknown ids are ignored
        (the replica may have been removed concurrently). Quarantine +
        probed readmission proceed exactly as for internal evictions."""
        with self._lock:
            replica = self._replicas.get(replica_id)
        if replica is not None:
            self._evict(replica, reason)

    def _evict(self, replica: Replica, reason: str) -> None:
        with self._lock:
            if replica.state is not ReplicaState.ACTIVE:
                return
            replica.state = ReplicaState.QUARANTINED
            replica.backoff_s = self.quarantine_base_s
            replica.quarantined_until = (time.monotonic()
                                         + self.quarantine_base_s)
            replica.stats["evictions"] += 1
            self.stats["evictions"] += 1
        logger.warning("pool %s: replica %s EVICTED (%s); quarantined, "
                       "first probe in %.2fs", self.name, replica.id,
                       reason, self.quarantine_base_s)
        obs_flight.record("fabric", "evict",
                          {"pool": self.name, "replica": replica.id,
                           "reason": reason[:200]})
        # in-flight connections die NOW so their waiters fail fast and
        # retry elsewhere instead of riding out the full timeout
        if replica.link is not None:
            replica.link.close_all()

    def _readmit(self, replica: Replica) -> None:
        with self._lock:
            if replica.state is not ReplicaState.QUARANTINED:
                return
            replica.state = ReplicaState.ACTIVE
            replica.score = 1.0
            replica.samples = 0
            replica.consecutive_failures = 0
            replica.backoff_s = 0.0
            replica.stats["readmissions"] += 1
            self.stats["readmissions"] += 1
            self._cond.notify_all()
        logger.info("pool %s: replica %s READMITTED", self.name, replica.id)
        obs_flight.record("fabric", "readmit",
                          {"pool": self.name, "replica": replica.id})

    def _record_success(self, replica: Replica) -> None:
        with self._lock:
            replica.samples += 1
            replica.consecutive_failures = 0
            replica.score += _SCORE_ALPHA * (1.0 - replica.score)

    def _record_failure(self, replica: Replica) -> Optional[str]:
        with self._lock:
            replica.samples += 1
            replica.consecutive_failures += 1
            replica.score += _SCORE_ALPHA * (0.0 - replica.score)
            replica.stats["failures"] += 1
            evict_why = None
            if replica.consecutive_failures >= self.fail_threshold:
                evict_why = (f"{replica.consecutive_failures} consecutive "
                             "failures")
            elif (replica.samples >= _SCORE_MIN_SAMPLES
                    and replica.score < _SCORE_FLOOR):
                evict_why = f"health score {replica.score:.2f} collapsed"
        if evict_why:
            self._evict(replica, evict_why)
        return evict_why

    # -- routing -------------------------------------------------------------
    def _key_hash(self, key) -> int:
        if key is None:
            # keyless requests spread over the ring by sequence number
            return _hash64(f"seq:{next(self._keyless_seq)}")
        return _hash64(str(key))

    def _route_locked(self, h: int, exclude) -> Optional[Replica]:
        """Bounded-load consistent hashing: walk the ring from the key's
        point; the first ACTIVE replica under the load bound wins, else
        spill onward; if every candidate is over the bound, take the
        least-loaded (the bound sheds hot spots, it must not reject)."""
        if not self._ring:
            return None
        # fabric replica-canary routing comes before the ring: a stable
        # slice of the keyspace goes to the canary replica, and keys
        # OUTSIDE the slice skip it (otherwise the canary would also
        # keep its natural ring share and serve ~fraction + 1/N of the
        # traffic instead of ~fraction)
        canary_rid = None
        if self._canary is not None:
            rid, fraction, _version = self._canary
            canary = self._replicas.get(rid)
            if canary is not None and canary.state is ReplicaState.ACTIVE:
                if (rid not in exclude
                        and (h % 10_000) / 10_000.0 < fraction):
                    return canary
                canary_rid = rid
        n_active = sum(1 for r in self._replicas.values()
                       if r.state is ReplicaState.ACTIVE)
        if n_active == 0:
            return None
        bound = max(1.0, self.load_factor
                    * (self._inflight_total + 1) / n_active)
        start = bisect.bisect_left(self._points, h) % len(self._ring)
        seen = set()
        fallback: Optional[Replica] = None
        canary_fallback: Optional[Replica] = None
        first_owner = True
        for i in range(len(self._ring)):
            _, rid = self._ring[(start + i) % len(self._ring)]
            if rid in seen:
                continue
            seen.add(rid)
            r = self._replicas.get(rid)
            if r is None or r.state is not ReplicaState.ACTIVE or rid in exclude:
                continue
            if rid == canary_rid:
                # out-of-slice keys avoid the canary; it stays the last
                # resort so a pool reduced to its canary still serves
                canary_fallback = r
                continue
            if r.inflight + 1 <= bound:
                if not first_owner:
                    self.stats["spills"] += 1
                return r
            first_owner = False
            if fallback is None or r.inflight < fallback.inflight:
                fallback = r
        return fallback if fallback is not None else canary_fallback

    def _acquire(self, h: int, exclude) -> Optional[Replica]:
        with self._lock:
            r = self._route_locked(h, exclude)
            if r is not None:
                r.inflight += 1
                r.stats["requests"] += 1
                self._inflight_total += 1
            return r

    def _release(self, replica: Replica) -> None:
        with self._lock:
            replica.inflight -= 1
            self._inflight_total -= 1
            self._cond.notify_all()  # drain waiters watch inflight

    # -- overload shedding (autoscaler at the ceiling) ------------------------
    def set_overload_shed(self, min_priority: int) -> None:
        """Arm graceful degradation: :meth:`request` calls with
        ``priority >= min_priority`` (LOWER values are more important)
        are refused immediately with a typed
        :class:`~..serving.request.OverloadShedError` instead of joining
        a queue that cannot drain. Armed by the autoscaler when the
        replica set cannot grow (max replicas / no memory headroom)."""
        with self._lock:
            self._shed_min_priority = int(min_priority)

    def clear_overload_shed(self) -> None:
        with self._lock:
            self._shed_min_priority = None

    def overload_shed(self) -> Optional[int]:
        """The armed priority cutoff, or None while disarmed."""
        with self._lock:
            return self._shed_min_priority

    # -- the request path ----------------------------------------------------
    def request(self, tensors, key=None, timeout: float = 5.0,
                deadline: Optional[float] = None,
                meta: Optional[dict] = None,
                priority: int = 0) -> Buffer:
        """Send one request through the fabric; returns the answer Buffer.

        ``key`` — idempotency/affinity key: same key, same replica
        (modulo load spill), and failed attempts RETRY on another
        replica. ``deadline`` (absolute ``time.monotonic()``) overrides
        ``timeout``; whatever remains is propagated to every attempt and
        rides the frame meta. ``priority`` (lower = more important) only
        matters while the overload guard is armed: sheddable classes
        then fail fast with a typed error. Raises
        :class:`NoReplicaAvailable` / :class:`RequestFailed` only after
        the budget is exhausted."""
        if deadline is None:
            deadline = time.monotonic() + timeout
        h = self._key_hash(key)
        with self._lock:
            self.stats["requests"] += 1
            shed_cutoff = self._shed_min_priority
        if shed_cutoff is not None and priority >= shed_cutoff:
            from ..serving.request import OverloadShedError

            with self._lock:
                self.stats["shed_overload"] += 1
            raise OverloadShedError(
                f"pool '{self.name}' at capacity: request "
                f"(priority {priority}) shed by the overload guard "
                f"(cutoff {shed_cutoff}) — the autoscaler cannot grow "
                "the replica set")
        span = None
        if obs_context.TRACING:
            # root span for THIS request — or a child, when the caller
            # already carries a context in meta["trace"]; every attempt
            # below becomes a child span whose context rides the wire
            span = obs_context.start_span(
                f"fabric.request:{self.name}", kind="fabric",
                parent=obs_context.TraceContext.from_meta(
                    (meta or {}).get("trace")),
                attrs={"pool": self.name,
                       "key": None if key is None else str(key)})
        try:
            return self._request_traced(tensors, key, deadline, meta,
                                        timeout, h, span)
        finally:
            # exception-safe span close (NNL3xx stance): the terminal
            # paths below end the span with their own status first, so
            # this end() is a no-op for them — it only catches an
            # UNEXPECTED exception escaping mid-loop, which must not
            # leak a live root span (its attempts end the same way)
            if span is not None:
                span.end("error:escaped")

    def _request_traced(self, tensors, key, deadline: float,
                        meta: Optional[dict], timeout: float, h,
                        span) -> Buffer:
        t_req = time.monotonic()
        retriable = self.assume_idempotent or key is not None
        max_attempts = self.max_attempts if retriable else 1
        tried: set = set()
        attempts = 0
        last_err: Optional[BaseException] = None
        while attempts < max_attempts:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            replica = self._acquire(h, tried)
            if replica is None and tried:
                # nothing routable outside the exclusions: a once-failed
                # replica that is still ACTIVE beats failing a request
                # that has budget left — forget the exclusions and retry
                tried = set()
                replica = self._acquire(h, tried)
            if replica is None:
                # every replica quarantined/draining: wait a slice for a
                # readmission instead of failing a request with budget
                with self._cond:
                    self._cond.wait(min(remaining, 0.05))
                if time.monotonic() >= deadline:
                    break
                continue
            if attempts > 0:
                with self._lock:
                    self.stats["retries"] += 1
            attempt_span = None
            if span is not None:
                attempt_span = obs_context.start_span(
                    f"attempt:{replica.id}", kind="fabric", parent=span,
                    attrs={"replica": replica.id, "attempt": attempts})
            try:
                buf = self._make_buffer(
                    tensors, key, deadline, attempts, meta,
                    trace=None if attempt_span is None
                    else attempt_span.context())
                if retriable:
                    resp, err = self._attempt_maybe_hedged(
                        replica, h, tried, buf, tensors, key, deadline,
                        meta, span=span, attempt_span=attempt_span)
                else:
                    # hedging IS duplicate execution — a non-idempotent
                    # request must never fan out, same gate as retries
                    resp, err = self._attempt_and_score(replica, buf,
                                                        deadline)
                if attempt_span is not None:
                    # idempotent: a hedge win already ended the primary's
                    # span as superseded — this end() is then a no-op, so
                    # the success is never misattributed to a replica
                    # that did not answer
                    attempt_span.end(
                        "ok" if resp is not None else
                        f"error:{type(err).__name__}" if err is not None
                        else "error")
            finally:
                # exception-safe close: the normal path above already
                # ended with its real status (end() is idempotent)
                if attempt_span is not None:
                    attempt_span.end("error:escaped")
            if resp is not None:
                dt = time.monotonic() - t_req
                self._latency_hist.observe(dt, pool=self.name)
                if obs_profile.ACTIVE:
                    # the SLO plane's fabric request series: windowed
                    # latency digests + outcome counts per pool
                    obs_profile.record_request(f"fabric:{self.name}", dt,
                                               ok=True)
                if span is not None:
                    span.end("ok")
                return resp
            last_err = err
            tried.add(replica.id)
            attempts += 1
        with self._lock:
            self.stats["request_errors"] += 1
        dt = time.monotonic() - t_req
        self._latency_hist.observe(dt, pool=self.name)
        if obs_profile.ACTIVE:
            obs_profile.record_request(f"fabric:{self.name}", dt, ok=False)
        obs_flight.record(
            "fabric", "request_error",
            {"pool": self.name, "attempts": attempts,
             "error": None if last_err is None else str(last_err)[:200]})
        if last_err is None:
            if span is not None:
                span.end("error:NoReplicaAvailable")
            raise NoReplicaAvailable(
                f"pool '{self.name}': no replica could take the request "
                f"within {timeout:.2f}s (replicas: {self.replicas()})")
        if span is not None:
            span.end(f"error:{type(last_err).__name__}")
        raise RequestFailed(
            f"pool '{self.name}': request failed after {attempts} "
            f"attempt(s): {last_err}") from last_err

    def _make_buffer(self, tensors, key, deadline: float, attempt: int,
                     meta: Optional[dict], trace=None) -> Buffer:
        import numpy as np

        buf = Buffer([np.asarray(t) for t in tensors])
        if meta:
            buf.meta.update(meta)
        # deadline propagation: the server side (e.g. a serving scheduler
        # behind attach_scheduler) can shed work that cannot finish in
        # the remaining budget instead of wasting a batch slot on it
        buf.meta["fabric"] = {
            "deadline_s": round(max(0.0, deadline - time.monotonic()), 4),
            "key": None if key is None else str(key),
            "attempt": attempt,
        }
        # trace propagation: the attempt span's context crosses the wire
        # in the DATA frame's JSON meta, so the replica's serving batch
        # and fused-segment spans land in THIS request's trace
        if trace is not None:
            buf.meta["trace"] = trace.to_meta()
        return buf

    def _attempt_and_score(self, replica: Replica, buf: Buffer,
                           deadline: float):
        """One attempt on one replica: call, score, release. Returns
        (response, None) or (None, error). Only REPLICA faults (link
        death, no answer, connect failure) feed the health score —
        request-level outcomes must not evict healthy capacity:

        * a typed server shed (RemoteError — e.g. serving admission
          control refusing an exhausted deadline budget) is the replica
          WORKING as designed; under overload, scoring sheds as
          failures would evict replicas exactly when capacity is
          scarcest;
        * a deadline that expired before the attempt even dialed says
          nothing about the replica.
        Both still count as failed attempts (the caller retries
        elsewhere), they just leave the score alone."""
        from ..query.client import RemoteError

        if deadline - time.monotonic() <= 0:
            self._release(replica)
            return None, TimeoutError("deadline exhausted before attempt")
        try:
            resp = replica.link.call(buf, deadline)
        except RemoteError as e:
            self._release(replica)
            return None, e
        except Exception as e:  # noqa: BLE001 - every failure class retries
            self._release(replica)
            self._record_failure(replica)
            return None, e
        self._release(replica)
        self._record_success(replica)
        return resp, None

    def _attempt_maybe_hedged(self, replica: Replica, h: int, tried: set,
                              buf: Buffer, tensors, key, deadline: float,
                              meta: Optional[dict], span=None,
                              attempt_span=None):
        """Run one attempt; when hedging is on and the primary is slow,
        fire a duplicate on another replica and take the first answer.
        ``span`` — the request's root span: the hedge duplicate gets its
        own child span (it is a distinct wire attempt). ``attempt_span``
        — the PRIMARY's span: on a hedge win it is closed as superseded
        here, so the hedge replica's answer is never attributed to the
        slow primary."""
        hedge_after = self.hedge_after_s
        remaining = deadline - time.monotonic()
        if hedge_after is None or remaining <= hedge_after:
            return self._attempt_and_score(replica, buf, deadline)
        primary_q: _queue.Queue = _queue.Queue()
        t = threading.Thread(
            target=lambda: primary_q.put(
                self._attempt_and_score(replica, buf, deadline)),
            name=f"fabric:{self.name}:attempt", daemon=True)
        t.start()
        self._threads.track(t)
        try:
            return primary_q.get(timeout=hedge_after)
        except _queue.Empty:
            pass
        hedge_replica = self._acquire(h, tried | {replica.id})
        if hedge_replica is None:
            # nowhere to hedge: wait the primary out (it is bounded by
            # the request deadline, +1s slack for teardown)
            try:
                return primary_q.get(
                    timeout=max(0.1, deadline - time.monotonic()) + 1.0)
            except _queue.Empty:
                return None, TimeoutError(
                    "attempt did not complete within the deadline")
        with self._lock:
            self.stats["hedges"] += 1
        obs_flight.record("fabric", "hedge",
                          {"pool": self.name, "primary": replica.id,
                           "hedge": hedge_replica.id})
        hedge_span = None
        if span is not None:
            hedge_span = obs_context.start_span(
                f"attempt:{hedge_replica.id}", kind="fabric", parent=span,
                attrs={"replica": hedge_replica.id, "hedge": True})
        hedge_buf = self._make_buffer(
            tensors, key, deadline, -1, meta,
            trace=None if hedge_span is None else hedge_span.context())
        resp2, err2 = self._attempt_and_score(hedge_replica, hedge_buf,
                                              deadline)
        if hedge_span is not None:
            hedge_span.end("ok" if resp2 is not None else
                           f"error:{type(err2).__name__}" if err2 is not None
                           else "error")
        if resp2 is not None:
            with self._lock:
                self.stats["hedge_wins"] += 1
            if attempt_span is not None:
                # truthful trace: the primary never answered — the hedge
                # did (its own span carries the "ok")
                attempt_span.end("superseded:hedge-won")
            # the primary finishes on its own deadline; its late answer
            # (or failure) is scored and discarded by the worker thread
            return resp2, None
        # hedge lost too: exclude IT from the next retry as well, and
        # fall back to whatever the primary produces
        tried.add(hedge_replica.id)
        try:
            return primary_q.get(
                timeout=max(0.1, deadline - time.monotonic()) + 1.0)
        except _queue.Empty:
            return None, err2

    # -- draining (rolling swap) ---------------------------------------------
    def drain_replica(self, replica_id: str, timeout: float = 10.0) -> None:
        """Stop routing NEW requests to the replica and wait until its
        in-flight count hits zero (rolling-swap step 1)."""
        with self._lock:
            r = self._replicas.get(replica_id)
            if r is None:
                raise FabricError(f"pool '{self.name}': unknown replica "
                                  f"'{replica_id}'")
            if r.state is ReplicaState.ACTIVE:
                r.state = ReplicaState.DRAINING
            deadline = time.monotonic() + timeout
            while r.inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise FabricError(
                        f"pool '{self.name}': replica '{replica_id}' still "
                        f"has {r.inflight} in-flight after {timeout:.1f}s "
                        "drain")
                self._cond.wait(min(remaining, 0.2))

    def undrain_replica(self, replica_id: str) -> None:
        with self._lock:
            r = self._replicas.get(replica_id)
            if r is not None and r.state is ReplicaState.DRAINING:
                r.state = ReplicaState.ACTIVE
                self._cond.notify_all()

    # -- canary routing -------------------------------------------------------
    def set_canary(self, replica_id: str, fraction: float,
                   version: str = "") -> None:
        if not 0.0 < fraction < 1.0:
            raise ValueError(f"canary fraction {fraction} must be in (0,1)")
        with self._lock:
            if replica_id not in self._replicas:
                raise FabricError(f"pool '{self.name}': unknown replica "
                                  f"'{replica_id}'")
            self._canary = (replica_id, fraction, version)

    def clear_canary(self) -> None:
        with self._lock:
            self._canary = None

    # -- observability --------------------------------------------------------
    def control_endpoints(self) -> Dict[str, Optional[str]]:
        """{replica_id: control-endpoint URL or None} — the fleet-view
        discovery contract (obs/fleet.py): replicas registered with a
        ``control=`` URL/callable advertise it here; a callable that
        raises (replica down, mid-respawn) reads as None, so the
        scraper marks the replica instead of crashing its tick."""
        with self._lock:
            entries = [(r.id, r.control) for r in self._replicas.values()]
        out: Dict[str, Optional[str]] = {}
        for rid, control in entries:
            if callable(control):
                try:
                    out[rid] = control()
                except Exception:  # noqa: BLE001 - down/mid-respawn
                    out[rid] = None
            else:
                out[rid] = control
        return out

    def snapshot(self) -> dict:
        with self._lock:
            entries = [(r, r.snapshot_locked())
                       for r in self._replicas.values()]
            out = {
                "name": self.name,
                "replicas": [e for _r, e in entries],
                "inflight_total": self._inflight_total,
                "canary": (None if self._canary is None else
                           {"replica": self._canary[0],
                            "fraction": self._canary[1],
                            "version": self._canary[2]}),
                "overload_shed": self._shed_min_priority,
                **self.stats,
            }
        # service probes outside the pool lock (they take Service._lock)
        for r, entry in entries:
            if r.service is not None:
                entry["service"] = {"name": r.service.name,
                                    "state": r.service.state.value,
                                    "ready": r.service.readiness()}
        return out


# ---------------------------------------------------------------------------
# ServiceFabric: supervised in-process replica services behind one pool
# ---------------------------------------------------------------------------

# query-server ids for fabric replicas live far above the hand-assigned
# test/demo range so a fabric never collides with a user's serversrc id
_fabric_qid = itertools.count(7100)


class ServiceFabric:
    """N supervised replica services (each one query-server pipeline:
    ``serversrc ! <stage> ! serversink``) registered behind one
    :class:`ReplicaPool`, plus the cross-replica rollout verbs.

    ``stage`` is the replica's processing chain, e.g.
    ``"tensor_filter framework=torch model=registry://slot"`` — binding
    through a ``registry://`` slot is what makes :meth:`rolling_swap`
    and :meth:`canary` work."""

    def __init__(self, manager, name: str, stage: str, caps: str, *,
                 replicas: int = 3, restart=None, host: str = "127.0.0.1",
                 **pool_kwargs):
        self.manager = manager
        self.name = name
        self.stage = stage
        self.caps_str = caps
        self.host = host
        self.n_replicas = replicas
        self.restart = restart
        self.pool = ReplicaPool(name, caps, **pool_kwargs)
        self._services: List = []
        # replica ids, aligned with _services: scale_out appends with a
        # MONOTONIC index (never reused), scale_in pops — so a regrown
        # replica can never collide with a removed one's pool entry
        self._rids: List[str] = []
        self._next_index = 0
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServiceFabric":
        if self._started:
            return self
        for _ in range(self.n_replicas):
            self._spawn_replica(self._next_index)
        self._started = True
        return self

    def _spawn_replica(self, index: int, warm: bool = False):
        qid = next(_fabric_qid)
        launch = (
            f"tensor_query_serversrc name=qsrc id={qid} host={self.host} "
            f"port=0 caps={self.caps_str} ! {self.stage} "
            f"! tensor_query_serversink id={qid}")
        svc = self.manager.register(
            f"{self.name}-r{index}", launch, warmup="none",
            restart=self.restart,
            description=f"fabric '{self.name}' replica {index}")
        svc.start()
        rid = f"{self.name}-r{index}"
        try:
            port = self._bound_port(svc)
        except FabricError:
            # the service is registered + started but NOT yet tracked in
            # _services — unregister it here or stop() can never reach it
            try:
                self.manager.unregister(svc.name)
            except Exception:  # noqa: BLE001 - surface the bind failure
                logger.exception("fabric %s: unregister of unbound replica "
                                 "%s failed", self.name, svc.name)
            raise
        if warm:
            self._warm_replica(port)
        self._services.append(svc)
        self._rids.append(rid)
        self._next_index = max(self._next_index, index + 1)
        self.pool.add_endpoint(
            self.host, port, replica_id=rid, service=svc,
            resolver=lambda s=svc: (self.host,
                                    self._bound_port(s, timeout=1.0)))
        return svc

    def _warm_replica(self, port: int, timeout: float = 60.0) -> None:
        """One zero-tensor inference through the query wire BEFORE the
        replica joins the ring, so a scaled-out replica never serves its
        first forward to a live request (the subprocess runner's
        self-warmup, in-process edition). Flexible caps skip; a warmup
        failure only logs — the replica still joins and warms on first
        traffic, which is the pre-warm behavior."""
        import numpy as np

        from ..core import Buffer
        from ..core.caps import tensors_info_from_caps
        from ..query.client import QueryClient

        try:
            info = tensors_info_from_caps(self.pool.caps)
            zeros = [np.zeros(tuple(s.shape), dtype=s.dtype.np_dtype)
                     for s in info.specs]
        except Exception:  # noqa: BLE001 - flexible/partial caps
            return
        try:
            client = QueryClient(self.host, port, timeout=timeout)
            try:
                client.connect(self.pool.caps)
                client.request(Buffer(zeros), timeout=timeout)
            finally:
                client.close()
        except Exception as e:  # noqa: BLE001 - warm is best-effort
            logger.warning("fabric %s: replica warmup on port %d failed "
                           "(%s); it will warm on first traffic",
                           self.name, port, e)

    # -- elastic scaling (autoscaler actuation) -------------------------------
    def replica_count(self) -> int:
        return len(self._services)

    def scale_out(self) -> str:
        """Grow the replica set by one: register + start a fresh replica
        service, WARM it through the query wire, and only then admit it
        to the ring (a replica added under load must take load, not
        serve its own cold start). Returns the new replica id."""
        index = self._next_index
        self._spawn_replica(index, warm=True)
        logger.info("fabric %s: scaled OUT to %d replicas", self.name,
                    len(self._services))
        return self._rids[-1]

    def scale_in(self, drain_timeout_s: float = 10.0) -> str:
        """Shrink by one: drain the newest non-canary replica (no new
        routes, in-flight flushes), remove it from the ring, and
        unregister its service. Returns the removed replica id."""
        if not self._services:
            raise FabricError(f"fabric '{self.name}': no replica to remove")
        canary = self.pool.snapshot().get("canary")
        canary_rid = canary["replica"] if canary else None
        idx = len(self._services) - 1
        if self._rids[idx] == canary_rid:
            if idx == 0:
                raise FabricError(
                    f"fabric '{self.name}': only the canary replica is "
                    "left — cancel or promote the canary before scaling in")
            idx -= 1
        rid = self._rids[idx]
        svc = self._services[idx]
        try:
            self.pool.drain_replica(rid, timeout=drain_timeout_s)
        except FabricError:
            # a drain timeout must not park the replica half-removed;
            # remove() below closes its links and retries fail over
            logger.warning("fabric %s: scale-in drain of %s timed out; "
                           "removing anyway", self.name, rid)
        self.pool.remove(rid)
        del self._services[idx]
        del self._rids[idx]
        try:
            self.manager.unregister(svc.name)
        except Exception:  # noqa: BLE001 - the ring is already consistent
            logger.exception("fabric %s: unregister %s failed", self.name,
                             svc.name)
        logger.info("fabric %s: scaled IN to %d replicas (removed %s)",
                    self.name, len(self._services), rid)
        return rid

    def _bound_port(self, svc, timeout: float = 5.0) -> int:
        """The replica's CURRENT listen port (ephemeral: changes across
        restarts — this is the resolver readmission probes call)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pipe = svc.pipeline
            if pipe is not None:
                el = pipe.get("qsrc")
                port = getattr(el, "bound_port", 0)
                if port:
                    return port
            time.sleep(0.01)
        raise FabricError(
            f"fabric '{self.name}': replica service '{svc.name}' never "
            "bound its query server port")

    def services(self) -> List:
        return list(self._services)

    def request(self, tensors, **kw) -> Buffer:
        return self.pool.request(tensors, **kw)

    def stop(self) -> None:
        """Pool first (no new routes), then drain + unregister every
        replica service."""
        self.pool.close()
        for svc in self._services:
            try:
                self.manager.unregister(svc.name)
            except Exception:  # noqa: BLE001 - tear the rest down regardless
                logger.exception("fabric %s: unregister %s failed",
                                 self.name, svc.name)
        self._services = []
        self._rids = []
        self._started = False

    # -- chaos hooks ---------------------------------------------------------
    def kill_replica(self, index: int) -> None:
        """Process-death analog: hard-stop the replica service (its
        listener and every connection die). The pool evicts it on the
        next failure/health tick; :meth:`revive_replica` brings it back
        (on a NEW port — the resolver re-finds it)."""
        self._services[index].stop()

    def revive_replica(self, index: int) -> None:
        self._services[index].start()

    # -- rolling rollout ------------------------------------------------------
    def rolling_swap(self, slot: str, version: str,
                     drain_timeout_s: float = 10.0) -> dict:
        """Hot-swap ``slot`` to ``version`` one replica at a time: drain
        (no new routes, in-flight flushes) → flip only that replica's
        filters → readmit → next. Traffic keeps flowing through the
        other replicas the whole time — zero request errors."""
        rolled = []
        for svc in self._services:
            rid = self._rid_for(svc)
            # drain INSIDE the try: a drain timeout must also undrain,
            # or the replica is parked DRAINING forever (never routed,
            # never probed — quarantine only watches QUARANTINED)
            try:
                self.pool.drain_replica(rid, timeout=drain_timeout_s)
                self.manager.models.swap(slot, version, services=[svc])
            finally:
                self.pool.undrain_replica(rid)
            rolled.append(rid)
        logger.info("fabric %s: rolling swap %s -> %s complete (%d "
                    "replicas)", self.name, slot, version, len(rolled))
        return {"slot": slot, "version": version, "replicas": rolled}

    def canary(self, slot: str, version: str, fraction: float) -> dict:
        """Flip ONE replica to ``version`` (slot active version
        unchanged) and route ``fraction`` of the keyspace to it."""
        svc = self._services[0]
        rid = self._rid_for(svc)
        try:
            self.pool.drain_replica(rid)
            self.manager.models.swap(slot, version, services=[svc],
                                     activate=False)
        finally:
            self.pool.undrain_replica(rid)
        self.pool.set_canary(rid, fraction, version)
        return {"slot": slot, "canary": version, "fraction": fraction,
                "replica": rid}

    def promote_canary(self, slot: str, version: str) -> dict:
        """The canary graduates: roll every OTHER replica to ``version``
        (activating the slot), then clear the canary routing."""
        canary_svc = self._services[0]
        for svc in self._services:
            rid = self._rid_for(svc)
            try:
                self.pool.drain_replica(rid)
                if svc is canary_svc:
                    # already serving the candidate; just activate
                    self.manager.models.swap(slot, version, services=[])
                else:
                    self.manager.models.swap(slot, version, services=[svc])
            finally:
                self.pool.undrain_replica(rid)
        self.pool.clear_canary()
        return {"slot": slot, "version": version, "promoted": True}

    def cancel_canary(self, slot: str) -> dict:
        """Abort: flip the canary replica back to the slot's active
        version, THEN clear the routing — clearing first would hand the
        still-candidate replica its full ring share of all keys for the
        length of the drain (canceling a bad canary must shrink its
        exposure, never widen it; while DRAINING, routing skips it)."""
        svc = self._services[0]
        rid = self._rid_for(svc)
        active = self.manager.models.info(slot)["active"]
        try:
            self.pool.drain_replica(rid)
            self.manager.models.swap(slot, active, services=[svc],
                                     activate=False)
        finally:
            self.pool.undrain_replica(rid)
        self.pool.clear_canary()
        return {"slot": slot, "canceled": True, "active": active}

    def _rid_for(self, svc) -> str:
        try:
            return self._rids[self._services.index(svc)]
        except ValueError:
            raise FabricError(f"fabric '{self.name}': unknown service "
                              f"{svc.name}")

    def snapshot(self) -> dict:
        out = self.pool.snapshot()
        out["services"] = [s.name for s in self._services]
        return out
