#!/usr/bin/env python
"""Chaos harness for the PyTorch port: drive nnstreamer_tpu_torch's
service fabric through every failover path.

The port's counterpart of ``tools/chaos.py``, with its CLI and its nine
scenarios. Each scenario builds a fabric of supervised query-server
services behind one :class:`~nnstreamer_tpu_torch.service.fabric.
ReplicaPool` (or a set of ``python -m nnstreamer_tpu_torch replica``
processes), runs sustained request traffic against it, injects ONE class
of fault mid-traffic, and gates on the fabric's core promise: **zero
client-visible request errors** — every fault is masked by retry, hedge,
eviction, or readmission. Faults are injected through the port's
``elements/fault.py`` :data:`net_chaos` (transport-level: connection
kill, delay, partition) and through service verbs (process-death analog:
hard service stop).

The replicas' filter stages run on the card (``cuda:0``) unless
``--device cpu`` asks for the CPU. The models are the reference's:
``builtin://scaler?factor=2`` (and ``factor=3`` as the swap target), and
``builtin://sleeper?ms=40&factor=2`` for load-ramp. ``--proc-model
mobilenet_v2`` makes proc-replica-kill's replicas serve MobileNet-v2 at
full width (224×224×3, 1001 classes) instead of the scaler.

Scenarios
=========

``replica-kill``   hard-stop one replica mid-traffic; it must be evicted,
                   traffic rerouted, and (after revive) readmitted.
``conn-kill``      kill a live connection after N frames (net_chaos
                   drop_conn_at); the pool retries on another replica.
``partition``      partition one replica for a window; evict while
                   unreachable, readmit after the partition heals.
``slow-replica``   delay one replica's link; hedging keeps tail latency
                   bounded by the healthy replicas.
``rolling-swap``   registry:// hot swap rolled across all replicas
                   (drain → flip → readmit each) under traffic.
``load-ramp``      offered load ramps up then back down against an
                   AUTOSCALED fabric (service/autoscaler.py): the
                   replica count must track load in BOTH directions,
                   steady-state p99 after scale-out must hold within
                   the SLO, and the whole ramp costs zero errors.
``proc-replica-kill``  SIGKILL a live SUBPROCESS replica
                   (service/procreplica.py) under traffic: evict →
                   autoscaler respawn → readmit, zero client-visible
                   errors.
``shm-peer-kill``  SIGKILL the shm peer: the ring reclaims every slot,
                   and a fleet over the rings loses a replica with zero
                   client-visible errors.
``wire-corruption``  fuzz the NNSB mutation catalog
                   (tools/wirefuzz_torch.py) into live connections of one
                   replica under traffic: typed outcomes on the poisoned
                   links only, zero errors for other clients, threads +
                   shm slots reclaimed (LEAKCHECK-clean).

Each scenario also reports its traffic's p99 latency and, where a
replica leaves the pool, the seconds from the fault to its eviction and
from its return to its readmission.

Usage::

    python tools/chaos_torch.py --device cpu          # all, JSON report
    python tools/chaos_torch.py --device cpu --smoke  # replica-kill +
                                 # conn-kill + load-ramp + proc-replica-kill
                                 # + shm-peer-kill + wire-corruption
    python tools/chaos_torch.py --scenario partition  # on the card
    NNS_TSAN=1 NNS_LEAKCHECK=1 python tools/chaos_torch.py --smoke

Exit nonzero when any scenario reports errors, or, under ``NNS_TSAN=1``,
when the port's sanitizer recorded a lock-order violation, or, under
``NNS_LEAKCHECK=1``, when a paired resource is still outstanding after
the run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

CAPS = "other/tensors,format=static,dimensions=4,types=float32"
MB_CAPS = "other/tensors,format=static,dimensions=3:224:224:1,types=float32"
MB_MODEL = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model"
SMOKE = ["replica-kill", "conn-kill", "load-ramp", "proc-replica-kill",
         "shm-peer-kill", "wire-corruption"]

# where the replicas' filters run ("cuda" = the card; set by main)
DEVICE = "cuda"
# what proc-replica-kill's replicas serve: "scaler" or "mobilenet_v2"
PROC_MODEL = "scaler"


def _stage(model: str) -> str:
    """The replicas' filter stage, on the card unless DEVICE is cpu."""
    where = " accelerator=cpu" if DEVICE == "cpu" else ""
    return f"tensor_filter framework=torch{where} model={model}"


def _scaler_frame(i: int):
    import numpy as np

    return [np.full(4, float(i % 17), np.float32)]


def _mobilenet_frame(i: int):
    import numpy as np

    rng = np.random.default_rng(i % 8)
    return [rng.uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)]


def _p99(samples) -> float:
    s = sorted(samples)
    return s[int(0.99 * (len(s) - 1))] if s else 0.0


class Traffic:
    """Sustained request load from N worker threads; counts outcomes and
    keeps each answered request's latency."""

    def __init__(self, fabric, rate_hz: float = 100.0, workers: int = 2,
                 timeout: float = 8.0, frame=_scaler_frame):
        self.fabric = fabric
        self.period = 1.0 / rate_hz
        self.timeout = timeout
        self.frame = frame
        self.errors: list = []
        self.latencies: list = []
        self.ok = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, name=f"fabric:traffic:{i}",
                             daemon=True)
            for i in range(workers)]

    def _run(self) -> None:
        i = 0
        me = threading.current_thread().name
        while not self._stop.is_set():
            i += 1
            t0 = time.monotonic()
            try:
                out = self.fabric.request(
                    self.frame(i), key=f"{me}:{i}", timeout=self.timeout)
                assert out.tensors, "empty answer"
                with self._lock:
                    self.ok += 1
                    self.latencies.append(time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001 - every error is the signal
                with self._lock:
                    self.errors.append(f"{type(e).__name__}: {e}")
            self._stop.wait(self.period)

    def p99_s(self) -> float:
        with self._lock:
            return round(_p99(self.latencies), 4)

    def __enter__(self) -> "Traffic":
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.timeout + 2.0)


def _fabric(mgr, name: str, **pool_kw):
    from nnstreamer_tpu_torch.service import ServiceFabric

    pool_kw.setdefault("quarantine_base_s", 0.2)
    pool_kw.setdefault("health_poll_s", 0.05)
    fab = ServiceFabric(mgr, name, _stage("registry://chaos"), CAPS,
                        replicas=3, **pool_kw)
    fab.start()
    return fab


def _warmup(fab, n: int = 6, frame=_scaler_frame) -> None:
    """The first invoke per replica builds its model (and, on the card,
    its kernels); chaos latency numbers must not include cold starts."""
    for i in range(n):
        fab.request(frame(0), key=f"warm{i}", timeout=30.0)


def _wait_counter(pool, key: str, want: int, timeout: float = 10.0) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        n = pool.snapshot()[key]
        if n >= want:
            return n
        time.sleep(0.05)
    return pool.snapshot()[key]


def _timed_counter(pool, key: str, want: int, since: float,
                   timeout: float = 10.0):
    """(counter, seconds from ``since`` until it reached ``want``)."""
    n = _wait_counter(pool, key, want, timeout)
    return n, round(time.monotonic() - since, 4)


def _scenario(name: str):
    def deco(fn):
        SCENARIOS[name] = fn
        return fn
    return deco


SCENARIOS: dict = {}


@_scenario("replica-kill")
def replica_kill(mgr, duration: float) -> dict:
    """Kill one of 3 replicas mid-traffic (process-death analog), then
    revive it; traffic never sees an error, the pool evicts + readmits."""
    fab = _fabric(mgr, "chaos-kill")
    try:
        _warmup(fab)
        with Traffic(fab) as tr:
            time.sleep(duration / 3)
            t_kill = time.monotonic()
            fab.kill_replica(1)
            evicted, t_evict = _timed_counter(fab.pool, "evictions", 1,
                                              t_kill)
            time.sleep(duration / 3)
            t_revive = time.monotonic()
            fab.revive_replica(1)
            readmitted, t_readmit = _timed_counter(
                fab.pool, "readmissions", 1, t_revive)
            time.sleep(duration / 3)
        snap = fab.snapshot()
        return {"requests": tr.ok, "errors": tr.errors,
                "evictions": evicted, "readmissions": readmitted,
                "retries": snap["retries"], "p99_s": tr.p99_s(),
                "t_evict_s": t_evict, "t_readmit_s": t_readmit,
                "ok": (not tr.errors and tr.ok > 0
                       and evicted >= 1 and readmitted >= 1)}
    finally:
        fab.stop()


@_scenario("conn-kill")
def conn_kill(mgr, duration: float) -> dict:
    """Kill live connections to one replica after a few frames; retries
    on other replicas mask every kill."""
    from nnstreamer_tpu_torch.elements.fault import net_chaos

    fab = _fabric(mgr, "chaos-conn")
    try:
        _warmup(fab)
        port = fab._bound_port(fab.services()[0])
        kills = 0
        with Traffic(fab) as tr:
            deadline = time.monotonic() + duration
            while time.monotonic() < deadline:
                net_chaos.drop_conn_at(port, 3)
                kills += 1
                time.sleep(duration / 5)
        chaos = net_chaos.snapshot()
        net_chaos.clear()
        return {"requests": tr.ok, "errors": tr.errors,
                "kills_armed": kills, "conns_killed": chaos["killed_conns"],
                "p99_s": tr.p99_s(),
                "ok": (not tr.errors and tr.ok > 0
                       and chaos["killed_conns"] >= 1)}
    finally:
        net_chaos.clear()
        fab.stop()


@_scenario("partition")
def partition(mgr, duration: float) -> dict:
    """Partition one replica's port for a window; the pool evicts it,
    and readmits only after the partition heals (probes fail through)."""
    from nnstreamer_tpu_torch.elements.fault import net_chaos

    fab = _fabric(mgr, "chaos-part")
    try:
        _warmup(fab)
        port = fab._bound_port(fab.services()[2])
        with Traffic(fab) as tr:
            time.sleep(duration / 4)
            t_cut = time.monotonic()
            net_chaos.partition_for_s(port, duration / 4)
            evicted, t_evict = _timed_counter(fab.pool, "evictions", 1,
                                              t_cut)
            readmitted, _ = _timed_counter(
                fab.pool, "readmissions", 1, t_cut,
                timeout=duration / 2 + 8)
            # the partition heals duration / 4 after the cut
            t_readmit = round(time.monotonic() - t_cut - duration / 4, 4)
            time.sleep(duration / 4)
        net_chaos.clear()
        return {"requests": tr.ok, "errors": tr.errors,
                "evictions": evicted, "readmissions": readmitted,
                "p99_s": tr.p99_s(),
                "t_evict_s": t_evict, "t_readmit_s": t_readmit,
                "ok": (not tr.errors and tr.ok > 0
                       and evicted >= 1 and readmitted >= 1)}
    finally:
        net_chaos.clear()
        fab.stop()


@_scenario("slow-replica")
def slow_replica(mgr, duration: float) -> dict:
    """Delay one replica's link well past the hedge threshold; hedged
    duplicates on healthy replicas keep the tail bounded."""
    import numpy as np

    from nnstreamer_tpu_torch.elements.fault import net_chaos

    fab = _fabric(mgr, "chaos-slow", hedge_after_s=0.1)
    try:
        _warmup(fab)
        port = fab._bound_port(fab.services()[1])
        lat: list = []
        net_chaos.delay_ms(port, 500)
        deadline = time.monotonic() + duration
        errors: list = []
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            try:
                fab.request([np.ones(4, np.float32)],
                            key=f"s{len(lat)}", timeout=8.0)
                lat.append(time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001
                errors.append(f"{type(e).__name__}: {e}")
        net_chaos.clear()
        snap = fab.snapshot()
        lat.sort()
        p95 = lat[int(0.95 * (len(lat) - 1))] if lat else 0.0
        return {"requests": len(lat), "errors": errors,
                "hedges": snap["hedges"], "hedge_wins": snap["hedge_wins"],
                "p95_s": round(p95, 4), "p99_s": round(_p99(lat), 4),
                # a hedged fabric must beat the injected 500 ms floor a
                # delayed round-trip (2 delayed sends) would cost
                "ok": (not errors and len(lat) > 0
                       and snap["hedges"] >= 1 and p95 < 0.5)}
    finally:
        net_chaos.clear()
        fab.stop()


@_scenario("load-ramp")
def load_ramp(mgr, duration: float) -> dict:
    """Closed-loop autoscaling gate: a 1-replica fabric (sleeper model —
    fixed ms of REAL service time per request, so capacity is
    deterministic) takes a low → high → low load ramp. The autoscaler
    must grow the replica set while the short burn window is hot, hold
    post-scale-out p99 within the SLO, and shrink back to min once
    every window cools — all at zero client-visible request errors."""
    import numpy as np

    from nnstreamer_tpu_torch.service import Autoscaler, AutoscalerConfig
    from nnstreamer_tpu_torch.service.fabric import ServiceFabric

    slo_s = 0.25
    fab = ServiceFabric(
        mgr, "chaos-ramp", _stage("builtin://sleeper?ms=40&factor=2"),
        CAPS, replicas=1, quarantine_base_s=0.2, health_poll_s=0.05)
    fab.start()
    cfg = AutoscalerConfig(
        min_replicas=1, max_replicas=3,
        latency_slo_s=0.1, target=0.9,
        short_window_s=2.0, long_window_s=6.0,
        scale_out_burn=3.0, scale_in_burn=0.8, min_samples=6,
        scale_out_cooldown_s=1.5, scale_in_cooldown_s=3.0,
        tick_s=0.25)
    scaler = Autoscaler(fab, cfg, name="chaos-ramp")
    lat_lock = threading.Lock()
    latencies: list = []      # (t_done, seconds)
    errors: list = []
    stop_evt = threading.Event()
    high_evt = threading.Event()

    def worker(i: int, low_period: float) -> None:
        n = 0
        while not stop_evt.is_set():
            if i > 0 and not high_evt.is_set():
                # extra workers only push during the high phase
                high_evt.wait(0.1)
                continue
            n += 1
            t0 = time.monotonic()
            try:
                fab.request([np.full(4, float(n % 13), np.float32)],
                            key=f"w{i}:{n}", timeout=10.0)
                with lat_lock:
                    latencies.append((time.monotonic(),
                                      time.monotonic() - t0))
            except Exception as e:  # noqa: BLE001 - every error gates
                with lat_lock:
                    errors.append(f"{type(e).__name__}: {e}")
            if not high_evt.is_set():
                stop_evt.wait(low_period)

    try:
        _warmup(fab, 4)
        scaler.start()
        workers = [threading.Thread(target=worker, args=(i, 0.06),
                                    name=f"fabric:ramp:{i}", daemon=True)
                   for i in range(8)]
        max_seen = 1
        for t in workers:
            t.start()

        def watch(seconds: float) -> int:
            nonlocal max_seen
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline:
                max_seen = max(max_seen, fab.replica_count())
                time.sleep(0.1)
            return fab.replica_count()

        low1 = max(3.0, duration)
        high = max(9.0, 2.0 * duration)
        watch(low1)                      # phase 1: 1 worker trickle
        high_evt.set()                   # phase 2: all 8, closed loop
        t_high0 = time.monotonic()
        watch(high)
        t_high1 = time.monotonic()
        high_evt.clear()                 # phase 3: back to the trickle
        # scale-in needs the LONG window to cool + the cooldown to pass
        scaled_in_to_min = False
        deadline = time.monotonic() + max(25.0, cfg.long_window_s
                                          + 4 * cfg.scale_in_cooldown_s)
        while time.monotonic() < deadline:
            if fab.replica_count() <= cfg.min_replicas:
                scaled_in_to_min = True
                break
            time.sleep(0.2)
        stop_evt.set()
        high_evt.set()  # unblock parked extra workers so they can exit
        for t in workers:
            t.join(timeout=12.0)
        with lat_lock:
            # steady-state AFTER scale-out: the last 40% of the high
            # phase (the ramp transient before capacity arrived is what
            # TRIGGERED the scaling, not what the gate judges)
            t_late = t_high1 - 0.4 * (t_high1 - t_high0)
            late = sorted(s for (td, s) in latencies
                          if t_late <= td <= t_high1)
            all_n = len(latencies)
            p99_all = _p99([s for _, s in latencies])
            errs = list(errors)
        p99_late = late[int(0.99 * (len(late) - 1))] if late else 0.0
        snap = scaler.snapshot()
        return {"requests": all_n, "errors": errs,
                "max_replicas_seen": max_seen,
                "final_replicas": fab.replica_count(),
                "scaled_in_to_min": scaled_in_to_min,
                "scale_out_events": snap["scale_out"],
                "scale_in_events": snap["scale_in"],
                "p99_steady_high_s": round(p99_late, 4),
                "p99_s": round(p99_all, 4),
                "slo_s": slo_s,
                "samples_steady_high": len(late),
                "ok": (not errs and all_n > 0
                       and max_seen >= 2
                       and snap["scale_out"] >= 1
                       and snap["scale_in"] >= 1
                       and scaled_in_to_min
                       and len(late) > 10
                       and p99_late <= slo_s)}
    finally:
        scaler.stop()
        stop_evt.set()
        high_evt.set()
        fab.stop()


def _proc_set(name: str, model: str = "scaler"):
    """Two ``python -m nnstreamer_tpu_torch replica`` processes behind a
    pool, serving the chaos slot's scaler (or MobileNet-v2)."""
    from nnstreamer_tpu_torch.service.procreplica import ProcReplicaSet

    if model == "mobilenet_v2":
        return ProcReplicaSet(name, _stage(MB_MODEL), MB_CAPS, replicas=2,
                              quarantine_base_s=0.2, health_poll_s=0.05)
    return ProcReplicaSet(
        name, _stage("registry://chaos"), CAPS, replicas=2,
        models={"chaos": {"versions": {"1": "builtin://scaler?factor=2"},
                          "active": "1"}},
        quarantine_base_s=0.2, health_poll_s=0.05)


def _proc_devices(ps) -> list:
    """The devices the set's live replicas opened their filters on (each
    replica's READY line reports them)."""
    with ps._lock:
        infos = [ps._slots[r].proc.info or {} for r in ps._order]
    return sorted({d for info in infos for d in info.get("devices") or ()})


def _respawn_cfg():
    from nnstreamer_tpu_torch.service import AutoscalerConfig

    return AutoscalerConfig(
        min_replicas=2, max_replicas=2, tick_s=0.2,
        respawn_backoff_base_s=0.3, max_respawns=4,
        scale_out_cooldown_s=60.0, scale_in_cooldown_s=60.0)


def _kill_and_respawn(ps, scaler, duration: float) -> dict:
    """SIGKILL replica 0 mid-traffic; wait for the eviction, the
    autoscaler's respawn and the readmission."""
    time.sleep(duration / 2)
    t_kill = time.monotonic()
    killed = ps.kill_replica(0)
    evicted, t_evict = _timed_counter(ps.pool, "evictions", 1, t_kill)
    # autoscaler tick: reap -> respawn (fresh pid, new port)
    deadline = time.monotonic() + 60.0
    respawned = 0
    while time.monotonic() < deadline and not respawned:
        respawned = scaler.snapshot()["respawns"]
        time.sleep(0.1)
    readmitted, t_readmit = _timed_counter(ps.pool, "readmissions", 1,
                                           t_kill, timeout=20.0)
    time.sleep(duration / 2)
    return {"killed": killed, "evictions": evicted, "respawns": respawned,
            "readmissions": readmitted, "t_evict_s": t_evict,
            "t_readmit_s": t_readmit}


@_scenario("proc-replica-kill")
def proc_replica_kill(mgr, duration: float) -> dict:
    """SIGKILL a live SUBPROCESS replica under traffic: the pool must
    evict it the moment its exit is observed, the autoscaler must
    respawn a fresh process under the same ring identity with backoff,
    and the pool must readmit it — zero client-visible errors while
    retries mask the whole window. (``mgr`` is unused: subprocess
    replicas own their manager in their own interpreter.)
    ``t_readmit_s`` counts from the kill: the respawn is inside it."""
    from nnstreamer_tpu_torch.service import Autoscaler

    frame = _mobilenet_frame if PROC_MODEL == "mobilenet_v2" \
        else _scaler_frame
    ps = _proc_set("chaos-proc", PROC_MODEL)
    scaler = Autoscaler(ps, _respawn_cfg(), name="chaos-proc")
    try:
        ps.start()
        _warmup(ps, 4, frame)
        scaler.start()
        with Traffic(ps, timeout=10.0, frame=frame) as tr:
            kill = _kill_and_respawn(ps, scaler, duration)
        snap = ps.snapshot()
        procs_alive = sum(1 for p in snap["processes"] if p["alive"])
        devices = _proc_devices(ps)
        return {"requests": tr.ok, "errors": tr.errors, **kill,
                "model": PROC_MODEL, "devices": devices,
                "processes_alive": procs_alive, "p99_s": tr.p99_s(),
                "retries": snap["retries"],
                "ok": (not tr.errors and tr.ok > 0
                       and kill["evictions"] >= 1
                       and kill["respawns"] >= 1
                       and kill["readmissions"] >= 1
                       and procs_alive == 2)}
    finally:
        scaler.stop()
        ps.stop()


@_scenario("shm-peer-kill")
def shm_peer_kill(mgr, duration: float) -> dict:
    """SIGKILL the shm peer (docs/transport.md slot lifecycle).

    Leg A, deterministic: a forked reader attaches the parent's ring,
    then dies by SIGKILL while every slot is in flight (it never
    releases one). The parent must reclaim all slots via the generation
    counters, outstanding descriptors must fail validation as typed
    ``FrameError``s (never a torn read), the ring must be immediately
    writable again, and the segment must unlink on detach.

    Leg B, fleet: same-host subprocess replicas negotiate ``binary+shm``
    automatically; SIGKILL one mid-traffic — evict, respawn, readmit
    with the fresh link re-negotiating shm, zero client-visible errors
    (``proc-replica-kill``'s bar, now with tensors riding the rings).
    """
    import multiprocessing

    import numpy as np

    from nnstreamer_tpu_torch import transport
    from nnstreamer_tpu_torch.core import Buffer
    from nnstreamer_tpu_torch.service import Autoscaler

    # -- leg A: generation-counter recovery under a real SIGKILL ----------
    ring = transport.create_ring(slots=2)  # pairs-with: detach_ring
    leg_a: dict = {}
    try:
        descs = []
        while True:
            d = ring.write_frame(transport.encode_frame(
                Buffer([np.arange(64, dtype=np.float32)])))
            if d is None:
                break  # ring full: every slot is now in flight
            descs.append(transport.unpack_descriptor(d))
        ready = multiprocessing.Event()

        def reader(name: str) -> None:
            peer = transport.attach_ring(name)  # pairs-with: detach_ring
            ready.set()
            time.sleep(300)  # hold the slots until SIGKILLed
            transport.detach_ring(peer)  # unreachable; contract partner

        proc = multiprocessing.Process(target=reader, args=(ring.name,),
                                       daemon=True)
        proc.start()
        assert ready.wait(10), "shm reader never attached"
        proc.kill()  # SIGKILL: no release, no detach
        proc.join(10)
        reclaimed = ring.reclaim()
        stale_typed = 0
        for _name, slot, gen, nbytes in descs:
            try:
                ring.read_frame(slot, gen, nbytes)
            except transport.FrameError:
                stale_typed += 1
        rewrite = ring.write_frame(transport.encode_frame(
            Buffer([np.zeros(8, np.float32)]))) is not None
        leg_a = {"slots_held": len(descs), "reclaimed": reclaimed,
                 "stale_descriptors_typed": stale_typed,
                 "writable_after_reclaim": rewrite,
                 "ok": (len(descs) == 2 and reclaimed == 2
                        and stale_typed == 2 and rewrite)}
    finally:
        seg = "/dev/shm/" + ring.name
        transport.detach_ring(ring)
        leg_a["segment_unlinked"] = not os.path.exists(seg)
        leg_a["ok"] = leg_a.get("ok", False) and leg_a["segment_unlinked"]

    # -- leg B: fleet traffic over the rings while a replica dies ---------
    ps = _proc_set("chaos-shm")
    scaler = Autoscaler(ps, _respawn_cfg(), name="chaos-shm")
    try:
        ps.start()
        _warmup(ps, 4)
        scaler.start()
        wires_before = [r["wire"] for r in ps.pool.snapshot()["replicas"]]
        with Traffic(ps, timeout=10.0) as tr:
            kill = _kill_and_respawn(ps, scaler, duration)
        wires_after = [r["wire"] for r in ps.pool.snapshot()["replicas"]]
        shm_links = all(w == "binary+shm" for w in wires_before + wires_after)
        leg_b = {"requests": tr.ok, "errors": tr.errors, **kill,
                 "wire_before": wires_before, "wire_after": wires_after,
                 "p99_s": tr.p99_s(),
                 "ok": (not tr.errors and tr.ok > 0
                        and kill["evictions"] >= 1
                        and kill["respawns"] >= 1
                        and kill["readmissions"] >= 1 and shm_links)}
    finally:
        scaler.stop()
        ps.stop()
    return {"requests": leg_b["requests"], "errors": leg_b["errors"],
            "p99_s": leg_b["p99_s"], "t_evict_s": leg_b["t_evict_s"],
            "t_readmit_s": leg_b["t_readmit_s"],
            "ring_recovery": leg_a, "fleet": leg_b,
            "ok": leg_a["ok"] and leg_b["ok"]}


@_scenario("wire-corruption")
def wire_corruption(mgr, duration: float) -> dict:
    """Fuzz the NNSB mutation catalog into live connections of ONE
    replica of a 3-replica fabric under traffic (tools/wirefuzz_torch.py
    is the shared catalog). The hostile-peer gate, now fleet-scale: every
    poisoned frame resolves as a TYPED outcome on the poisoned link
    only (server drop / typed ERROR / clean model answer — never a
    hang), the OTHER clients see zero errors, and every thread and shm
    slot the fuzzed links touched is reclaimed (LEAKCHECK-clean)."""
    import random
    import socket as _socket

    from nnstreamer_tpu_torch import transport
    from nnstreamer_tpu_torch.analysis import sanitizer
    from nnstreamer_tpu_torch.query.protocol import (MsgType, recv_msg,
                                                     send_msg)

    import wirefuzz_torch  # tools/ sibling: the shared mutation catalog

    had_leakcheck = sanitizer.leakcheck_enabled()
    if not had_leakcheck:
        sanitizer.enable_leakcheck()
    kinds = ("tracked_thread", "shm_segment")

    def _held() -> set:
        return {(r["kind"], r["key"]) for k in kinds
                for r in sanitizer.outstanding(k)}

    base_held = _held()
    fab = _fabric(mgr, "chaos-wire")
    try:
        _warmup(fab)
        port = fab._bound_port(fab.services()[0])
        rng = random.Random(19)
        baseline = wirefuzz_torch._baseline_buffers(rng, json_safe=True)[0][1]
        blob = bytes(transport.encode_frame_bytes(baseline))
        mutants = list(wirefuzz_torch.nnsb_mutants(blob, rng))
        typed = clean = 0
        untyped: list = []

        def _inject(mutation: str, mutant: bytes) -> None:
            nonlocal typed, clean
            s = _socket.create_connection(("127.0.0.1", port), timeout=5.0)
            s.settimeout(5.0)
            try:
                send_msg(s, MsgType.CAPABILITY, CAPS.encode())
                msg = recv_msg(s)
                assert msg is not None and msg[0] is MsgType.CAPABILITY
                send_msg(s, MsgType.DATA, mutant)
                try:
                    answer = recv_msg(s)
                except _socket.timeout:
                    untyped.append(f"{mutation}: no answer and no close")
                    return
                except (ConnectionError, OSError):
                    typed += 1  # torn mid-read: the link died, typed
                    return
                if answer is None or answer[0] is MsgType.ERROR:
                    typed += 1  # dropped link / typed ERROR frame
                else:
                    clean += 1  # mutant decoded coherently; model answered
            finally:
                s.close()

        with Traffic(fab) as tr:
            time.sleep(duration / 4)
            for mutation, mutant in mutants:
                try:
                    _inject(mutation, mutant)
                except Exception as e:  # noqa: BLE001 - every one gates
                    untyped.append(
                        f"{mutation}: {type(e).__name__}: {e}")
            time.sleep(duration / 4)
        snap = fab.snapshot()
    finally:
        fab.stop()
    leaked = sorted(f"{k}:{key}" for (k, key) in _held() - base_held)
    if not had_leakcheck:
        sanitizer.disable_leakcheck()
    return {"requests": tr.ok, "errors": tr.errors,
            "mutants_injected": len(mutants),
            "typed": typed, "clean": clean, "untyped": untyped,
            "leaked": leaked, "retries": snap["retries"],
            "p99_s": tr.p99_s(),
            "ok": (not tr.errors and tr.ok > 0 and not untyped
                   and not leaked and typed > 0
                   and typed + clean == len(mutants))}


@_scenario("rolling-swap")
def rolling_swap(mgr, duration: float) -> dict:
    """Roll the model slot across all replicas under traffic; zero
    errors, and traffic lands on the new version when the roll ends."""
    import numpy as np

    fab = _fabric(mgr, "chaos-roll")
    try:
        _warmup(fab)
        with Traffic(fab) as tr:
            time.sleep(duration / 3)
            rolled = fab.rolling_swap("chaos", "2")
            time.sleep(duration / 3)
        out = fab.request([np.ones(4, np.float32)], key="verify", timeout=8.0)
        factor = float(np.asarray(out.as_numpy().tensors[0]).reshape(-1)[0])
        return {"requests": tr.ok, "errors": tr.errors,
                "rolled": rolled["replicas"], "post_swap_factor": factor,
                "p99_s": tr.p99_s(),
                "ok": not tr.errors and tr.ok > 0 and factor == 3.0}
    finally:
        fab.stop()


def run(scenarios, duration: float) -> dict:
    from nnstreamer_tpu_torch.service import ServiceManager

    results = {}
    for name in scenarios:
        mgr = ServiceManager(jitter_seed=0)
        mgr.models.define("chaos", {"1": "builtin://scaler?factor=2",
                                    "2": "builtin://scaler?factor=3"},
                          active="1")
        t0 = time.monotonic()
        try:
            results[name] = SCENARIOS[name](mgr, duration)
        finally:
            mgr.shutdown()
        results[name]["seconds"] = round(time.monotonic() - t0, 3)
        status = "ok" if results[name]["ok"] else "FAILED"
        print(f"[chaos] {name}: {status} "
              f"({results[name].get('requests', 0)} requests, "
              f"{len(results[name].get('errors', []))} errors)",
              file=sys.stderr)
    report = {"bench": "fabric_chaos", "device": DEVICE,
              "scenarios": results,
              "ok": all(r["ok"] for r in results.values())}
    tsan = _tsan_verdict()
    if tsan is not None:
        report["tsan_violations"] = tsan
        report["ok"] = report["ok"] and not tsan
    leaks = _leak_verdict()
    if leaks is not None:
        report["leak_outstanding"] = leaks
        report["ok"] = report["ok"] and not leaks
    return report


def _tsan_verdict():
    """Under NNS_TSAN=1 the whole harness ran with instrumented locks —
    surface (and gate on) anything the port's sanitizer recorded."""
    from nnstreamer_tpu_torch.analysis import sanitizer

    if not sanitizer.is_enabled():
        return None
    return sanitizer.violations()


def _leak_verdict(grace_s: float = 5.0):
    """Under NNS_LEAKCHECK=1: every paired acquisition of the run must be
    released once the scenarios have stopped (a short grace window rides
    out teardown-time releases)."""
    from nnstreamer_tpu_torch.analysis import sanitizer

    if not sanitizer.leakcheck_enabled():
        return None
    deadline = time.monotonic() + grace_s
    rest = sanitizer.outstanding()
    while rest and time.monotonic() < deadline:
        time.sleep(0.1)
        rest = sanitizer.outstanding()
    return rest


def main(argv=None) -> int:
    global DEVICE, PROC_MODEL
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), nargs="+",
                    default=None,
                    help="run these scenarios (default: all; with --smoke, "
                         "the smoke set)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI: " + " + ".join(SMOKE) + ", short duration")
    ap.add_argument("--duration", type=float, default=None,
                    help="per-scenario traffic seconds")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the replicas' filters run (default: the "
                         "card)")
    ap.add_argument("--proc-model", default="scaler",
                    choices=("scaler", "mobilenet_v2"),
                    help="what proc-replica-kill's replicas serve")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    DEVICE, PROC_MODEL = args.device, args.proc_model
    if DEVICE != "cpu":
        import torch

        if not torch.cuda.is_available():
            ap.error("--device cuda: no CUDA card here (pass --device cpu)")
    from nnstreamer_tpu_torch.analysis import sanitizer

    if os.environ.get("NNS_TSAN") == "1":
        sanitizer.enable(hold_warn_s=5.0)
    if os.environ.get("NNS_LEAKCHECK") == "1":
        sanitizer.enable_leakcheck()
    if args.scenario:
        scenarios = list(args.scenario)
        duration = args.duration or (2.0 if args.smoke else 4.0)
    elif args.smoke:
        scenarios = list(SMOKE)
        duration = args.duration or 2.0
    else:
        scenarios = sorted(SCENARIOS)
        duration = args.duration or 4.0
    report = run(scenarios, duration)
    print(json.dumps(report, indent=2, default=str))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2, default=str)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    os._exit(rc)  # skip interpreter teardown of daemon threads
