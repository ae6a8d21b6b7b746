"""Process-isolated replicas: subprocess spawn, liveness, respawn (L7).

An in-process fabric replica shares one interpreter's fate (a
segfaulting backend, an OOM-killed process, a wedged GIL) with every
other replica. This module makes replicas REAL operating system
processes, each its own CUDA context (spawned with ``subprocess``, never
forked from a parent that may hold one):

``python -m nnstreamer_tpu_torch replica``
    The runner a replica process executes: build ONE query-server
    pipeline service (``tensor_query_serversrc ! <stage> !
    tensor_query_serversink``) under its own :class:`~.manager.ServiceManager`,
    start it, self-WARMUP (one inference through the real query wire, so
    the first forward on the device happens before any caller can route
    here), start a
    :class:`~.api.ControlServer` for liveness/metrics, optionally
    ADVERTISE over the existing MQTT-hybrid discovery path
    (``query/hybrid.py``), and only then print one ``NNS_REPLICA_READY
    {json}`` line on stdout — the parent admits the replica to the ring
    exactly when that line lands, never before.

:class:`ProcReplica`
    The parent-side handle: spawn → wait for the READY line → expose the
    advertised (host, query_port) + control endpoint. Liveness is
    two-level: :meth:`ProcReplica.alive` is the cheap process-level
    check (``Popen.poll``), :meth:`ProcReplica.healthy` asks the child's
    control endpoint (``GET /healthz``) — a zombie that still holds its
    sockets fails the second check.

:class:`ProcReplicaSet`
    N subprocess replicas behind one :class:`~.fabric.ReplicaPool` —
    the process-isolated sibling of :class:`~.fabric.ServiceFabric`,
    with the same elastic verbs the autoscaler drives
    (:meth:`~ProcReplicaSet.scale_out` / :meth:`~ProcReplicaSet.scale_in`
    / :meth:`~ProcReplicaSet.replica_count`) plus the subprocess-only
    ones: :meth:`~ProcReplicaSet.reap_dead` (a SIGKILLed replica is
    force-EVICTED from the ring the moment its exit is observed, not
    after ``fail_threshold`` request corpses) and
    :meth:`~ProcReplicaSet.respawn` (a fresh process takes over the dead
    replica's ring identity; the pool's quarantine probe re-resolves the
    NEW port and readmits — ``evict → respawn → readmit``, zero
    client-visible errors while retries mask the window).

Threading contract (docs/concurrency.md): ``ProcReplicaSet._lock``
guards only the slot table and is never held across a process spawn,
wait, or network call. The MUTATING verbs (scale_out/scale_in/respawn/
stop) are driven by one control thread at a time — the autoscaler loop
in production, the test body in tests — same single-actuator stance as
``ServiceFabric``'s rollout verbs. ``request``/``snapshot``/``reap_dead``
are safe from any thread.
"""
from __future__ import annotations

import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..analysis import sanitizer as _san
from ..analysis.sanitizer import named_lock
from ..obs import flight as obs_flight
from ..utils.log import logger
from ..utils.threads import ThreadRegistry
from .fabric import FabricError, ReplicaPool

#: stdout sentinel the runner prints when (and only when) the replica is
#: warmed up and serving — everything before it is free-form logging
READY_PREFIX = "NNS_REPLICA_READY "
# the directory that holds this package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ProcReplicaError(FabricError):
    """Subprocess replica lifecycle failure (spawn, readiness, respawn)."""


# ---------------------------------------------------------------------------
# parent side: one subprocess replica
# ---------------------------------------------------------------------------

_proc_seq = itertools.count()


class ProcReplica:
    """One replica subprocess. Build → :meth:`spawn` → :meth:`wait_ready`
    → route traffic at :meth:`address`; :meth:`kill` is the SIGKILL chaos
    hook, :meth:`terminate` the graceful stop."""

    def __init__(self, stage: str, caps: str, *,
                 name: Optional[str] = None,
                 host: str = "127.0.0.1",
                 models: Optional[dict] = None,
                 warmup: bool = True,
                 advertise: Optional[str] = None,
                 trace: bool = False,
                 obs: bool = True,
                 python: Optional[str] = None,
                 extra_args: Optional[List[str]] = None):
        self.stage = stage
        self.caps = caps
        self.host = host
        self.models = models
        self.warmup = warmup
        self.advertise = advertise
        # trace: the child enables request-scoped span tracing, so the
        # spans minted for wire trace ids are exportable at GET /spans
        # (cross-process stitching — obs/fleet.py); obs: the child keeps
        # request-digest recording on, so GET /profile?raw=1 carries the
        # windowed series the fleet merge reads
        self.trace = trace
        self.obs = obs
        self.name = name or f"replica-{os.getpid()}-{next(_proc_seq)}"
        self.python = python or sys.executable
        self.extra_args = list(extra_args or [])
        self.proc: Optional[subprocess.Popen] = None
        self.info: Optional[dict] = None   # the READY line's payload
        self._ready_evt = threading.Event()
        self._threads = ThreadRegistry()
        self._stdout_tail: List[str] = []  # last few lines, for errors

    # -- lifecycle -----------------------------------------------------------
    def spawn(self) -> "ProcReplica":
        if self.proc is not None:
            raise ProcReplicaError(f"replica '{self.name}' already spawned")
        cmd = [self.python, "-m", "nnstreamer_tpu_torch", "replica",
               "--name", self.name, "--stage", self.stage,
               "--caps", self.caps, "--host", self.host]
        if self.models:
            cmd += ["--models", json.dumps(self.models)]
        if not self.warmup:
            cmd += ["--no-warmup"]
        if self.trace:
            cmd += ["--trace"]
        if not self.obs:
            cmd += ["--no-obs"]
        if self.advertise:
            cmd += ["--advertise", self.advertise]
        cmd += self.extra_args
        # the child runs THIS copy of the package, wherever the parent
        # runs from (``-m`` would otherwise resolve it against the cwd)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        # stderr inherits (the child's logs interleave with ours, which
        # is what an operator tailing one journal wants); stdout is OURS:
        # the READY sentinel rides it
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                     env=env)
        if _san.LEAK:
            _san.note_acquire("proc_replica",
                              f"{self.name}:{self.proc.pid}")
        t = threading.Thread(target=self._read_stdout,
                             name=f"procreplica:{self.name}:stdout",
                             daemon=True)
        t.start()
        self._threads.track(t)
        return self

    def _read_stdout(self) -> None:
        proc = self.proc
        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                if line.startswith(READY_PREFIX):
                    try:
                        self.info = json.loads(line[len(READY_PREFIX):])
                    except ValueError:
                        logger.error("replica %s: unparseable READY line "
                                     "%r", self.name, line[:200])
                        continue
                    self._ready_evt.set()
                else:
                    self._stdout_tail.append(line)
                    del self._stdout_tail[:-8]
        except Exception:  # noqa: BLE001 - a dying pipe ends the reader
            pass
        finally:
            try:
                proc.stdout.close()
            except Exception:  # noqa: BLE001
                pass

    def wait_ready(self, timeout: float = 120.0) -> dict:
        """Block until the child prints its READY line; raises
        :class:`ProcReplicaError` on timeout or early exit."""
        deadline = time.monotonic() + timeout
        while not self._ready_evt.wait(0.1):
            rc = self.proc.poll() if self.proc is not None else None
            if rc is not None:
                raise ProcReplicaError(
                    f"replica '{self.name}' exited rc={rc} before READY "
                    f"(stdout tail: {self._stdout_tail[-3:]})")
            if time.monotonic() >= deadline:
                raise ProcReplicaError(
                    f"replica '{self.name}' not READY within {timeout:.0f}s")
        return self.info

    # -- probes --------------------------------------------------------------
    def alive(self) -> bool:
        """Process-level liveness: the subprocess has not exited."""
        return self.proc is not None and self.proc.poll() is None

    def healthy(self, timeout: float = 2.0) -> bool:
        """Control-endpoint liveness: the child's ``GET /healthz``
        answers (rides the retrying :class:`~.api.ControlClient`, so one
        dropped connection does not read as death)."""
        if not self.alive() or self.info is None:
            return False
        try:
            self.control(timeout=timeout).healthz()
            return True
        except Exception:  # noqa: BLE001 - any failure is "not healthy"
            return False

    @property
    def returncode(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    def address(self) -> Tuple[str, int]:
        """The advertised (host, query_port) — raises until READY, which
        keeps a pool resolver honest: a not-yet-ready replica fails its
        readmission probe instead of being handed traffic."""
        if self.info is None:
            raise ProcReplicaError(
                f"replica '{self.name}' has not advertised yet")
        return self.info["host"], int(self.info["query_port"])

    def control_endpoint(self) -> Optional[str]:
        """The child's control-plane URL, or None before READY — the
        fleet scraper's per-replica address (obs/fleet.py)."""
        if self.info is None:
            return None
        return f"http://{self.info['host']}:{self.info['control_port']}"

    def control(self, timeout: float = 10.0):
        from .api import ControlClient

        endpoint = self.control_endpoint()
        if endpoint is None:
            raise ProcReplicaError(
                f"replica '{self.name}' has not advertised yet")
        return ControlClient(endpoint, timeout=timeout)

    # -- teardown / chaos ----------------------------------------------------
    def kill(self) -> None:
        """SIGKILL — the chaos hook. No grace, no cleanup in the child:
        exactly what an OOM killer or a kernel panic does to a replica."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def terminate(self, timeout: float = 10.0) -> Optional[int]:
        """Graceful stop: SIGTERM (the runner drains its manager),
        escalate to SIGKILL after ``timeout``. Returns the exit code."""
        proc = self.proc
        if proc is None:
            return None
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                logger.warning("replica %s: SIGTERM ignored for %.0fs — "
                               "killing", self.name, timeout)
                proc.kill()
                proc.wait(timeout=5.0)
        self._threads.drain(timeout_per=2.0)
        if _san.LEAK:
            # every forget path (set stop, discard, failed admit, the
            # respawn replacing a dead child) funnels through terminate
            _san.note_release("proc_replica", f"{self.name}:{proc.pid}")
        return proc.returncode


# ---------------------------------------------------------------------------
# parent side: N subprocess replicas behind one pool
# ---------------------------------------------------------------------------

class _Slot:
    """One ring identity and the subprocess currently carrying it."""

    __slots__ = ("rid", "proc", "dead")

    def __init__(self, rid: str, proc: ProcReplica):
        self.rid = rid
        self.proc = proc
        self.dead = False  # exit observed + pool evicted (awaits respawn)


class ProcReplicaSet:
    """N process-isolated replicas behind one :class:`ReplicaPool` —
    the autoscaler's subprocess scaling target (see module docstring for
    the threading contract)."""

    def __init__(self, name: str, stage: str, caps: str, *,
                 replicas: int = 2,
                 host: str = "127.0.0.1",
                 models: Optional[dict] = None,
                 warmup: bool = True,
                 spawn_timeout_s: float = 120.0,
                 python: Optional[str] = None,
                 advertise: Optional[str] = None,
                 trace: bool = False,
                 obs: bool = True,
                 **pool_kwargs):
        self.name = name
        self.stage = stage
        self.caps_str = caps
        self.host = host
        self.models = models
        self.warmup = warmup
        self.spawn_timeout_s = spawn_timeout_s
        self.python = python
        self.advertise = advertise
        self.trace = trace
        self.obs = obs
        self.n_replicas = replicas
        self.pool = ReplicaPool(name, caps, **pool_kwargs)
        self._lock = named_lock(f"ProcReplicaSet._lock:{name}")
        self._slots: Dict[str, _Slot] = {}   # guarded-by: _lock
        self._order: List[str] = []          # guarded-by: _lock
        self._next_index = itertools.count()
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def _build_proc(self, rid: str) -> ProcReplica:
        return ProcReplica(self.stage, self.caps_str, name=rid,
                           host=self.host, models=self.models,
                           warmup=self.warmup, python=self.python,
                           advertise=self.advertise, trace=self.trace,
                           obs=self.obs)

    def start(self) -> "ProcReplicaSet":
        """Spawn the initial replicas CONCURRENTLY (each pays its own
        interpreter + first-forward cold start; serializing N of them would cost
        N× the worst one), then admit each as its READY line lands."""
        if self._started:
            return self
        pending = [self._spawn(wait=False) for _ in range(self.n_replicas)]
        for slot in pending:
            self._admit(slot)
        self._started = True
        return self

    def _spawn(self, wait: bool = True) -> _Slot:
        rid = f"{self.name}-p{next(self._next_index)}"
        slot = _Slot(rid, self._build_proc(rid).spawn())
        with self._lock:
            self._slots[rid] = slot
            self._order.append(rid)
        if wait:
            self._admit(slot)
        return slot

    def _admit(self, slot: _Slot) -> None:
        """Wait for the replica's READY advertisement, then join the
        ring. On failure the slot is discarded (never admitted)."""
        try:
            slot.proc.wait_ready(timeout=self.spawn_timeout_s)
        except ProcReplicaError:
            slot.proc.terminate(timeout=2.0)
            with self._lock:
                self._slots.pop(slot.rid, None)
                if slot.rid in self._order:
                    self._order.remove(slot.rid)
            raise
        host, port = slot.proc.address()
        self.pool.add_endpoint(
            host, port, replica_id=slot.rid,
            resolver=lambda rid=slot.rid: self._resolve(rid),
            control=lambda rid=slot.rid: self._control_endpoint(rid))
        obs_flight.record("fabric", "replica_spawned",
                          {"pool": self.name, "replica": slot.rid,
                           "pid": slot.proc.proc.pid, "port": port})

    def _resolve(self, rid: str) -> Tuple[str, int]:
        """Pool resolver: the CURRENT process behind the ring identity.
        Raises while dead/mid-respawn — the quarantine probe keeps
        failing (and backing off) until a live process advertises."""
        with self._lock:
            slot = self._slots.get(rid)
        if slot is None or slot.dead:
            raise ConnectionError(f"replica '{rid}' has no live process")
        return slot.proc.address()

    def _control_endpoint(self, rid: str) -> Optional[str]:
        """The CURRENT process's control URL behind a ring identity
        (None while dead/mid-respawn) — the pool's ``control=`` hook."""
        with self._lock:
            slot = self._slots.get(rid)
        if slot is None or slot.dead:
            return None
        return slot.proc.control_endpoint()

    def control_endpoints(self) -> Dict[str, Optional[str]]:
        """{replica_id: control URL or None} — the fleet-view discovery
        contract (obs/fleet.py): every ring identity's CURRENT child
        control endpoint; None marks a dead/mid-respawn replica so the
        scraper reports it instead of hammering a gone port."""
        with self._lock:
            rids = list(self._order)
        return {rid: self._control_endpoint(rid) for rid in rids}

    # -- elastic scaling (autoscaler actuation) -------------------------------
    def replica_count(self) -> int:
        """Ring identities with a live (or respawnable) process — what
        the autoscaler compares against min/max bounds."""
        with self._lock:
            return len(self._slots)

    def scale_out(self) -> str:
        slot = self._spawn(wait=True)
        logger.info("procset %s: scaled OUT to %d replicas (%s)",
                    self.name, self.replica_count(), slot.rid)
        return slot.rid

    def scale_in(self, drain_timeout_s: float = 10.0) -> str:
        """Remove the newest live replica: drain → leave ring → SIGTERM."""
        with self._lock:
            live = [r for r in self._order if not self._slots[r].dead]
            if not live:
                raise ProcReplicaError(
                    f"procset '{self.name}': no live replica to remove")
            rid = live[-1]
            slot = self._slots[rid]
        try:
            self.pool.drain_replica(rid, timeout=drain_timeout_s)
        except FabricError:
            logger.warning("procset %s: scale-in drain of %s timed out; "
                           "removing anyway", self.name, rid)
        self.pool.remove(rid)
        with self._lock:
            self._slots.pop(rid, None)
            if rid in self._order:
                self._order.remove(rid)
        slot.proc.terminate()
        logger.info("procset %s: scaled IN to %d replicas (removed %s)",
                    self.name, self.replica_count(), rid)
        return rid

    # -- liveness / respawn ---------------------------------------------------
    def reap_dead(self) -> List[str]:
        """Observe replica-process exits: every NEWLY dead replica is
        force-evicted from the ring (fail-fast: blocked waiters die with
        their connections and retry elsewhere) and returned. The
        autoscaler calls this each tick and owns the respawn schedule."""
        newly_dead: List[Tuple[str, Optional[int]]] = []
        with self._lock:
            for rid in self._order:
                slot = self._slots[rid]
                if not slot.dead and not slot.proc.alive():
                    slot.dead = True
                    newly_dead.append((rid, slot.proc.returncode))
        for rid, rc in newly_dead:
            obs_flight.record("fabric", "replica_dead",
                              {"pool": self.name, "replica": rid,
                               "returncode": rc})
            logger.warning("procset %s: replica %s process EXITED rc=%s",
                           self.name, rid, rc)
            self.pool.evict(rid, f"process exited rc={rc}")
        return [rid for rid, _ in newly_dead]

    def respawn(self, rid: str) -> bool:
        """Spawn a fresh process under a dead replica's ring identity.
        On READY the slot flips live and the pool's quarantine probe —
        whose resolver now sees the NEW port — readmits it. Returns
        False (without side effects beyond the failed process) when the
        spawn itself fails; the autoscaler's backoff retries."""
        with self._lock:
            slot = self._slots.get(rid)
            if slot is None:
                return False
            if not slot.dead:
                return True  # raced with a concurrent recovery
        proc = self._build_proc(rid)
        try:
            proc.spawn()
            proc.wait_ready(timeout=self.spawn_timeout_s)
        except ProcReplicaError as e:
            proc.terminate(timeout=2.0)
            logger.warning("procset %s: respawn of %s failed: %s",
                           self.name, rid, e)
            return False
        with self._lock:
            slot = self._slots.get(rid)
            if slot is None:           # removed (scale-in) mid-respawn
                replaced = None
            else:
                replaced, slot.proc = slot.proc, proc
                slot.dead = False
        if slot is None:
            proc.terminate(timeout=2.0)
            return False
        # reap the dead child we just replaced OUTSIDE the lock: its
        # stdout-reader thread was never joined and the Popen handle
        # never waited — a leak per respawn cycle under crash-loop chaos
        # (terminate on an already-dead process only drains/reaps)
        if replaced is not None:
            replaced.terminate(timeout=2.0)
        obs_flight.record("fabric", "replica_respawned",
                          {"pool": self.name, "replica": rid,
                           "pid": proc.proc.pid,
                           "port": proc.address()[1]})
        logger.info("procset %s: replica %s respawned (pid %d)",
                    self.name, rid, proc.proc.pid)
        return True

    def discard(self, rid: str) -> None:
        """Give up on a replica identity (respawn circuit breaker): it
        leaves the ring and the slot table; the rest keep serving."""
        self.pool.remove(rid)
        with self._lock:
            slot = self._slots.pop(rid, None)
            if rid in self._order:
                self._order.remove(rid)
        if slot is not None:
            slot.proc.terminate(timeout=2.0)

    # -- chaos hooks ----------------------------------------------------------
    def kill_replica(self, index_or_rid) -> str:
        """SIGKILL a replica process (chaos): real process death — the
        OS reclaims everything, no goodbye on any socket."""
        with self._lock:
            rid = (self._order[index_or_rid]
                   if isinstance(index_or_rid, int) else index_or_rid)
            slot = self._slots[rid]
        slot.proc.kill()
        return rid

    # -- serving --------------------------------------------------------------
    def request(self, tensors, **kw):
        return self.pool.request(tensors, **kw)

    def services(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def snapshot(self) -> dict:
        out = self.pool.snapshot()
        with self._lock:
            out["processes"] = [
                {"replica": rid,
                 "pid": (self._slots[rid].proc.proc.pid
                         if self._slots[rid].proc.proc else None),
                 "alive": self._slots[rid].proc.alive(),
                 "dead": self._slots[rid].dead}
                for rid in self._order]
        return out

    def stop(self) -> None:
        """Pool first (no new routes), then terminate every process."""
        self.pool.close()
        with self._lock:
            slots = [self._slots[r] for r in self._order]
            self._slots.clear()
            self._order = []
        for slot in slots:
            try:
                slot.proc.terminate()
            except Exception:  # noqa: BLE001 - tear the rest down regardless
                logger.exception("procset %s: terminate %s failed",
                                 self.name, slot.rid)
        self._started = False


# ---------------------------------------------------------------------------
# child side: the `python -m nnstreamer_tpu_torch replica` runner
# ---------------------------------------------------------------------------

def _aot_warmup_inputs(pipeline) -> Optional[list]:
    """Batch-1 zeros fabricated from a cached AOT artifact's recorded
    inputs for this pipeline's head device stage (the symbolic batch
    set to 1) — how a flexible-caps replica warms up anyway: the
    artifact knows the trailing dims the caps string does not declare.
    None when the AOT plane is off or no artifact covers the topology."""
    if pipeline is None:
        return None
    from .. import aot
    from ..obs import profile as obs_profile

    cache = aot.default_cache()
    if cache is None:
        return None
    try:
        # only the topology half of the key matters here: the full key
        # would read negotiated caps, and warmup runs before the first
        # client connects
        topo = obs_profile.topology_hash(pipeline)
        # the wire input matches the HEAD device stage's inputs: rank
        # each artifact by where its stage head sits in the pipeline
        position = {obs_profile.canonical_base(el): idx
                    for idx, el in enumerate(pipeline.elements.values())}

        def head_rank(meta: dict) -> int:
            head = str(meta.get("stage", "")).split("..", 1)[0]
            return position.get(head, len(position))
        for meta in sorted(cache.metas(topology=topo), key=head_rank):
            inputs = aot.fabricate_inputs(meta, batch=1)
            if inputs:
                return inputs
    except Exception:  # noqa: BLE001 - fabrication is best-effort
        logger.exception("replica warmup: AOT input fabrication failed")
    return None


def _warmup_self(host: str, port: int, caps_str: str,
                 timeout: float = 60.0, pipeline=None) -> None:
    """One inference through the real query wire against ourselves, so
    the model's first forward on its device (kernel builds, the first
    library calls) and caps negotiation complete BEFORE the READY line
    admits us to any ring: the answer comes back only once the device
    finished it. Static caps fabricate zeros; with a cached AOT artifact
    of the topology a non-static batch no longer forbids warmup — the
    artifact's recorded inputs supply the shapes and the warmup request
    runs the saved program. Only when no artifact covers the topology
    either does the replica skip, and the skip is a
    ``replica``/``warmup_skipped`` flight event."""
    import numpy as np

    from ..core import Buffer, parse_caps_string
    from ..core.caps import tensors_info_from_caps
    from ..query.client import QueryClient

    caps = parse_caps_string(caps_str)
    fabricated = False
    try:
        info = tensors_info_from_caps(caps)
        if not info.specs:
            # format=flexible parses fine but declares zero static
            # specs — an empty warmup buffer exercises nothing
            raise ValueError("flexible caps declare no tensor specs")
        zeros = [np.zeros(tuple(s.shape), dtype=s.dtype.np_dtype)
                 for s in info.specs]
    except Exception as e:  # noqa: BLE001 - flexible/partial caps
        zeros = _aot_warmup_inputs(pipeline)
        if zeros is None:
            obs_flight.record("replica", "warmup_skipped",
                              {"reason": f"caps not static: {e}",
                               "caps": caps_str, "port": port})
            logger.info("replica warmup skipped (caps not static: %s; "
                        "no AOT artifact to fabricate from)", e)
            return
        fabricated = True
        logger.info("replica warmup: caps not static (%s) — fabricated "
                    "batch-1 inputs from the cached AOT artifact", e)
    client = QueryClient(host, port, timeout=timeout)
    try:
        try:
            client.connect(caps)
            client.request(Buffer(zeros), timeout=timeout)
        except Exception as e:  # noqa: BLE001 - fabricated shapes may
            # not negotiate; a failed OPTIONAL warmup must not kill the
            # replica — the static-caps contract never reaches here
            if not fabricated:
                raise
            obs_flight.record("replica", "warmup_skipped",
                              {"reason": f"fabricated warmup failed: {e}",
                               "caps": caps_str, "port": port})
            logger.info("replica warmup: fabricated warmup failed (%s) "
                        "— continuing without warmup", e)
    finally:
        client.close()


def _filter_devices(pipeline) -> List[str]:
    """The devices the pipeline's filters opened their models on (the
    READY line reports them: a replica meant for the card shows
    ``cuda:0`` there, never a quiet CPU fallback)."""
    from ..elements.filter import TensorFilter

    return sorted({str(el.backend_device)
                   for el in pipeline.elements.values()
                   if isinstance(el, TensorFilter)
                   and el.backend_device is not None})


def run_replica(args) -> int:
    """Entry for ``python -m nnstreamer_tpu_torch replica`` (see module
    docstring). Blocks until SIGTERM/SIGINT; exits 0 on a clean drain."""
    from . import ControlServer, ServiceManager
    from .fabric import _fabric_qid
    from .supervisor import RestartPolicy

    recording_on = False
    if getattr(args, "obs", True):
        # keep the request-digest recording half on (the cheap,
        # request-rate half — no per-hop element tracer), so the
        # parent's fleet scraper finds windowed series at
        # GET /profile?raw=1 even when nothing else switched the
        # profiler on in this process
        from ..obs import profile as obs_profile

        obs_profile.enable_recording()
        recording_on = True
    if getattr(args, "trace", False):
        # span tracing for cross-process stitching: trace ids arriving
        # on the query wire mint serving/fused spans HERE, exported at
        # this replica's GET /spans for the parent's FleetView to join
        from ..obs import context as obs_context

        obs_context.enable_tracing()
    mgr = ServiceManager()
    models = {}
    if args.models:
        text = args.models
        if text.startswith("@"):
            with open(text[1:]) as fh:
                text = fh.read()
        models = json.loads(text)
    for slot, entry in models.items():
        mgr.models.define(slot, entry["versions"], entry["active"])
    qid = next(_fabric_qid)
    launch = (
        f"tensor_query_serversrc name=qsrc id={qid} host={args.host} "
        f"port={args.port} caps={args.caps} ! {args.stage} "
        f"! tensor_query_serversink id={qid}")
    svc = mgr.register(args.name, launch, warmup="none",
                       restart=RestartPolicy.from_config(args.restart),
                       description=f"subprocess replica '{args.name}'")
    server = None
    stop_evt = threading.Event()

    def _on_signal(signum, _frame):
        logger.info("replica %s: signal %d — shutting down", args.name,
                    signum)
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        svc.start(wait=True)
        # the query server port binds during play(); resolve it the same
        # way ServiceFabric does for in-process replicas
        deadline = time.monotonic() + 30.0
        port = 0
        while time.monotonic() < deadline and not port:
            pipe = svc.pipeline
            el = pipe.get("qsrc") if pipe is not None else None
            port = int(getattr(el, "bound_port", 0) or 0)
            if not port:
                time.sleep(0.01)
        if not port:
            print("replica: query server never bound", file=sys.stderr)
            return 1
        # PIN the ephemeral port we just advertised: an in-process
        # supervised restart replays the same pipeline, and port=0 would
        # rebind somewhere else — invalidating the address every ring
        # resolver holds. Re-binding the same port keeps a restart
        # inside the normal evict→probe→readmit window.
        el.props["port"] = port
        warmup_s = None
        if args.warmup:
            t0 = time.perf_counter()
            _warmup_self(args.host, port, args.caps,
                         pipeline=svc.pipeline)
            warmup_s = time.perf_counter() - t0
        server = ControlServer(mgr, host=args.host,
                               port=args.control_port).start()
        if args.advertise:
            broker_host, broker_port, topic = args.advertise.split(":", 2)
            from ..query import hybrid

            hybrid.advertise(broker_host, int(broker_port), topic,
                             args.host, port)
        ready = {"name": args.name, "pid": os.getpid(), "host": args.host,
                 "query_port": port, "control_port": server.port,
                 "devices": _filter_devices(svc.pipeline),
                 # the replica's first batch (its warmup request), s
                 "warmup_s": warmup_s}
        print(READY_PREFIX + json.dumps(ready), flush=True)
        from .manager import ServiceState

        while not stop_evt.wait(0.2):
            if svc.state in (ServiceState.FAILED, ServiceState.STOPPED):
                # supervisor gave up (breaker/never-policy) or the
                # stream completed: exiting nonzero IS our advertisement
                # of death — the parent's reaper sees the exit and
                # evicts us. Transient not-playing windows (a supervised
                # restart mid stop/replay) are NOT death: the in-child
                # supervisor owns those, and the pinned port keeps our
                # advertised address valid across them.
                print("replica: service terminal "
                      f"(state={svc.state.value})", file=sys.stderr)
                return 1
        return 0
    finally:
        if args.advertise:
            try:
                broker_host, broker_port, topic = args.advertise.split(":", 2)
                from ..query import hybrid

                hybrid.withdraw(broker_host, int(broker_port), topic)
            except Exception:  # noqa: BLE001 - broker may be gone
                pass
        if server is not None:
            server.stop()
        mgr.shutdown()
        # nnlint: disable=NNL303 — the release condition IS the acquire
        # condition: `recording_on` is set iff enable_recording() ran
        # above (flag-correlated branches the path analysis cannot join)
        if recording_on:
            # balanced shutdown on the clean-drain exit (a SIGKILL'd
            # replica's release is the process exit itself)
            from ..obs import profile as obs_profile

            obs_profile.disable_recording()


def add_replica_args(parser) -> None:
    """CLI wiring for the ``replica`` verb (``__main__.py``)."""
    parser.add_argument("--name", default="replica",
                        help="replica/service name (also the default ring "
                             "identity)")
    parser.add_argument("--stage", required=True,
                        help="processing chain between serversrc and "
                             "serversink, e.g. 'tensor_filter "
                             "framework=torch model=registry://slot'")
    parser.add_argument("--caps", required=True,
                        help="query-server caps string")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="query server port (0 = ephemeral, "
                             "advertised on the READY line)")
    parser.add_argument("--control-port", type=int, default=0,
                        dest="control_port",
                        help="control endpoint port (0 = ephemeral)")
    parser.add_argument("--models", default=None,
                        help="model slots as JSON (or @file): "
                             '{"slot": {"versions": {...}, "active": v}}')
    parser.add_argument("--restart", default="on-failure",
                        help="in-process restart policy for the replica "
                             "service (never|on-failure|always)")
    parser.add_argument("--no-warmup", dest="warmup", action="store_false",
                        help="skip the self-warmup inference before READY")
    parser.add_argument("--trace", action="store_true",
                        help="enable request-scoped span tracing in the "
                             "replica (spans for wire trace ids export at "
                             "GET /spans — cross-process stitching, "
                             "docs/observability.md#fleet)")
    parser.add_argument("--no-obs", dest="obs", action="store_false",
                        help="disable the request-digest recording the "
                             "fleet scraper reads at GET /profile?raw=1")
    parser.add_argument("--advertise", default=None,
                        metavar="BROKER_HOST:BROKER_PORT:TOPIC",
                        help="also advertise the query address over "
                             "MQTT-hybrid discovery (query/hybrid.py)")
    parser.set_defaults(warmup=True, obs=True, fn=run_replica)
