"""The port's service fabric (``nnstreamer_tpu_torch/service/fabric.py``)
against nnstreamer_tpu's, on the CPU.

* routing: the port's consistent-hash ring with bounded load sends every
  key to the same replica as the reference's ring over the same replica
  ids (with a replica out of the ring, and with a canary slice);
* a port pool routes to reference replicas, and the answers equal the
  reference's own;
* the cases of the reference's ``tests/test_fabric.py`` on the port:
  key affinity and spread, ring stability, bounded-load spills, the
  propagated deadline, retries, eviction → quarantine → probed
  readmission, hedging, the idempotency gate, network chaos, the
  kill-one-of-three chaos gate (zero client-visible errors), hybrid
  re-discovery on a new port, the in-process ``ServiceFabric`` (rolling
  swap, canary, kill and revive), and deadline shedding at the server."""
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu.service.fabric as RF
from nnstreamer_tpu.runtime.parse import parse_launch as ref_parse_launch
from nnstreamer_tpu_torch.elements.fault import net_chaos
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.service import (
    NoReplicaAvailable,
    ReplicaPool,
    ReplicaState,
    RequestFailed,
    ServiceFabric,
    ServiceManager,
)

CAPS = "other/tensors,format=static,dimensions=4,types=float32"

pytestmark = pytest.mark.timeout_s(60)


def _serve(parse, framework, port=0, model="builtin://passthrough",
           server_id=0):
    pipe = parse(
        f"tensor_query_serversrc name=ssrc id={server_id} port={port} "
        f"caps={CAPS} ! tensor_filter framework={framework} model={model} "
        f"! tensor_query_serversink id={server_id}")
    pipe.play()
    src = pipe.get("ssrc")
    deadline = time.monotonic() + 5
    while src.bound_port == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    return pipe, src.bound_port


def start_echo_server(port=0, model="builtin://passthrough", server_id=0):
    """The port's server pipeline: serversrc ! filter ! serversink."""
    return _serve(parse_launch, "torch accelerator=cpu", port, model,
                  server_id)


def _pool(**kw):
    kw.setdefault("quarantine_base_s", 0.1)
    kw.setdefault("quarantine_max_s", 0.5)
    kw.setdefault("health_poll_s", 0.05)
    return ReplicaPool("test", CAPS, **kw)


def _req(pool, key, value=1.0, timeout=8.0):
    return pool.request([np.full(4, value, np.float32)], key=key,
                        timeout=timeout)


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert cond()


def _routes(pool, keys):
    with pool._lock:
        return [pool._route_locked(pool._key_hash(k), set()).id
                for k in keys]


@pytest.mark.parametrize("case", ["ring", "evicted", "canary", "vnodes"])
def test_keys_route_to_the_reference_replica(case):
    """The same replica ids in the port's pool and the reference's pick the
    same replica for each of 400 keys (no servers: routing only)."""
    kw = {"vnodes": 7} if case == "vnodes" else {}
    pools = [ReplicaPool("parity", CAPS, **kw),
             RF.ReplicaPool("parity", CAPS, **kw)]
    try:
        for pool in pools:
            for i in range(5):
                pool.add_endpoint("127.0.0.1", 1 + i, replica_id=f"r{i}")
            if case == "evicted":
                with pool._lock:
                    pool._replicas["r2"].state = pool._replicas[
                        "r2"].state.__class__.QUARANTINED
            if case == "canary":
                pool.set_canary("r3", 0.2, "2")
        keys = [f"key-{i}" for i in range(400)] + list(range(50))
        got, want = (_routes(p, keys) for p in pools)
        assert got == want
        assert len(set(got)) == (4 if case == "evicted" else 5)
    finally:
        for pool in pools:
            pool.close()


def test_port_pool_routes_to_reference_replicas():
    """Wire parity: a port pool over three nnstreamer_tpu servers; the
    answers equal the reference's scaler and its retries mask a death."""
    servers = [_serve(ref_parse_launch, "jax", server_id=880 + i,
                      model="builtin://scaler?factor=2") for i in range(3)]
    pool = _pool()
    try:
        for i, (_pipe, port) in enumerate(servers):
            pool.add_endpoint("127.0.0.1", port, replica_id=f"j{i}")
        for k in range(12):
            out = _req(pool, f"k{k}", value=float(k))
            np.testing.assert_array_equal(np.asarray(out.tensors[0]),
                                          np.full(4, 2.0 * k, np.float32))
        servers[0][0].stop()
        for k in range(12):
            out = _req(pool, f"k{k}", value=1.0)
            np.testing.assert_array_equal(np.asarray(out.tensors[0]),
                                          np.full(4, 2.0, np.float32))
        assert pool.snapshot()["request_errors"] == 0
    finally:
        pool.close()
        for pipe, _port in servers:
            pipe.stop()


@pytest.fixture(autouse=True)
def _chaos_counters():
    """The chaos plane is one per process and its counters outlive
    ``clear()``: give them back as they were, for later tests in this
    process that count from zero."""
    saved = dict(net_chaos.stats)
    yield
    net_chaos.clear()
    net_chaos.stats.update(saved)


@pytest.fixture()
def echo3():
    """Three echo-server replicas (scaler x2) + a pool routing to them."""
    servers = []
    pool = _pool()
    try:
        for i in range(3):
            pipe, port = start_echo_server(
                server_id=800 + i, model="builtin://scaler?factor=2")
            servers.append([pipe, port])
            pool.add_endpoint("127.0.0.1", port, replica_id=f"r{i}")
        yield pool, servers
    finally:
        pool.close()
        for pipe, _port in servers:
            pipe.stop()
        net_chaos.clear()


class TestRouting:
    def test_roundtrip_and_key_affinity(self, echo3):
        pool, _servers = echo3
        out = _req(pool, "k0", value=3.0)
        assert np.allclose(np.asarray(out.tensors[0]), 6.0)
        # same key, same replica (no load pressure): request counters
        # move on exactly one replica across repeats
        for _ in range(5):
            _req(pool, "sticky")
        snap = pool.snapshot()
        hit = [r for r in snap["replicas"] if r["requests"] >= 5]
        assert len(hit) == 1, snap["replicas"]

    def test_keys_spread_over_replicas(self, echo3):
        pool, _servers = echo3
        for i in range(60):
            _req(pool, f"spread{i}")
        counts = [r["requests"] for r in pool.snapshot()["replicas"]]
        assert all(c > 0 for c in counts), counts

    def test_ring_stability_on_membership_change(self):
        """Consistent hashing: removing one replica only moves the keys
        it owned — keys owned by survivors stay put."""
        pool = _pool()
        for i in range(3):
            pool.add_endpoint("127.0.0.1", 10000 + i, replica_id=f"r{i}")
        def owner(key):
            with pool._lock:
                r = pool._route_locked(pool._key_hash(key), set())
            return r.id
        before = {f"key{i}": owner(f"key{i}") for i in range(100)}
        pool.remove("r1")
        moved = [k for k, rid in before.items()
                 if rid != "r1" and owner(k) != rid]
        assert not moved, f"{len(moved)} surviving keys moved: {moved[:5]}"
        pool.close()

    def test_bounded_load_spills(self, echo3):
        pool, _servers = echo3
        # find the owner of one key, saturate its inflight artificially,
        # and check the key spills to ANOTHER replica instead of queueing
        h = pool._key_hash("hot")
        with pool._lock:
            owner = pool._route_locked(h, set())
            owner.inflight = 50
            pool._inflight_total = 50
        try:
            with pool._lock:
                spilled = pool._route_locked(h, set())
            assert spilled is not None and spilled.id != owner.id
            assert pool.snapshot()["spills"] >= 1
        finally:
            with pool._lock:
                owner.inflight = 0
                pool._inflight_total = 0

    def test_deadline_exhaustion_raises(self):
        pool = _pool(max_attempts=2, connect_timeout=0.2)
        pool.add_endpoint("127.0.0.1", 1, replica_id="dead")  # nothing there
        with pytest.raises((RequestFailed, NoReplicaAvailable)):
            _req(pool, "k", timeout=0.6)
        assert pool.snapshot()["request_errors"] == 1
        pool.close()


class TestFailover:
    def test_retry_on_other_replica_masks_death(self, echo3):
        pool, servers = echo3
        for i in range(6):
            _req(pool, f"warm{i}")
        servers[0][0].stop()  # replica dies; its connections drop
        errors = 0
        for i in range(25):
            try:
                _req(pool, f"after{i}")
            except Exception:  # noqa: BLE001
                errors += 1
        snap = pool.snapshot()
        assert errors == 0, f"{errors} client-visible errors"
        assert snap["evictions"] >= 1
        assert snap["retries"] >= 1

    def test_evict_quarantine_readmit_cycle(self, echo3):
        pool, servers = echo3
        servers[1][0].stop()
        for i in range(12):
            _req(pool, f"x{i}")
        _wait(lambda: pool.snapshot()["evictions"] >= 1)
        states = {r["id"]: r["state"] for r in pool.snapshot()["replicas"]}
        assert "quarantined" in states.values(), states
        # restart on the SAME port: the probe readmits it
        pipe, port = start_echo_server(port=servers[1][1], server_id=810,
                                       model="builtin://scaler?factor=2")
        servers[1][0] = pipe
        _wait(lambda: pool.snapshot()["readmissions"] >= 1)
        states = {r["id"]: r["state"] for r in pool.snapshot()["replicas"]}
        assert all(s == "active" for s in states.values()), states

    def test_request_waits_out_full_quarantine(self, echo3):
        """Every replica down: a request with budget left blocks on the
        pool condition and SUCCEEDS once a replica is readmitted."""
        pool, servers = echo3
        for pipe, _ in servers:
            pipe.stop()
        for i in range(8):  # drive every replica into quarantine
            try:
                _req(pool, f"kill{i}", timeout=0.5)
            except Exception:  # noqa: BLE001 - expected while all are down
                pass
        _wait(lambda: all(r["state"] == "quarantined"
                          for r in pool.snapshot()["replicas"]))

        def revive():
            time.sleep(0.3)
            pipe, _ = start_echo_server(port=servers[2][1], server_id=811,
                                        model="builtin://scaler?factor=2")
            servers[2][0] = pipe
        t = threading.Thread(target=revive, name="fabric:test:revive")
        t.start()
        try:
            out = _req(pool, "patient", timeout=10.0)
            assert np.allclose(np.asarray(out.tensors[0]), 2.0)
        finally:
            t.join()

    def test_hedging_bounds_slow_replica_tail(self, echo3):
        pool, servers = echo3
        pool.hedge_after_s = 0.1
        for i in range(6):
            _req(pool, f"warm{i}")  # jit + connections warm
        net_chaos.delay_ms(servers[0][1], 500)
        lat = []
        for i in range(15):
            t0 = time.monotonic()
            _req(pool, f"h{i}")
            lat.append(time.monotonic() - t0)
        net_chaos.clear()
        snap = pool.snapshot()
        assert snap["hedges"] >= 1
        assert snap["request_errors"] == 0
        # a delayed round-trip costs >= 1s (two 500ms sends); hedging
        # must keep the worst case well under it
        assert max(lat) < 1.0, lat


class TestIdempotencyGate:
    def test_non_idempotent_pool_never_hedges(self):
        """Hedging is duplicate execution: a pool declared
        assume_idempotent=False must not fan a keyless request out to a
        second replica, even when the primary is slow enough to trip
        the hedge delay."""
        servers = []
        pool = ReplicaPool("noidem", CAPS, assume_idempotent=False,
                           hedge_after_s=0.05, quarantine_base_s=0.1,
                           health_poll_s=0.05)
        try:
            for i in range(2):
                pipe, port = start_echo_server(
                    server_id=830 + i, model="builtin://scaler?factor=2")
                servers.append((pipe, port))
                pool.add_endpoint("127.0.0.1", port, replica_id=f"r{i}")
            for i in range(4):  # warm jit + connections
                _req(pool, f"warm{i}")
            # keyed warm-ups may legally hedge (cold jit can outlast the
            # hedge delay); the contract under test is the DELTA for the
            # keyless request below
            hedges_before = pool.snapshot()["hedges"]
            for _pipe, port in servers:
                net_chaos.delay_ms(port, 200)  # both slow: hedge would fire
            out = pool.request([np.ones(4, np.float32)], timeout=8.0)
            assert np.allclose(np.asarray(out.tensors[0]), 2.0)
            assert pool.snapshot()["hedges"] == hedges_before
        finally:
            net_chaos.clear()
            pool.close()
            for pipe, _port in servers:
                pipe.stop()


class TestNetworkChaos:
    def test_partition_blocks_connect_then_heals(self, echo3):
        pool, servers = echo3
        from nnstreamer_tpu_torch.query.client import QueryClient
        from nnstreamer_tpu_torch.core import parse_caps_string

        net_chaos.partition_for_s(servers[0][1], 0.4)
        with pytest.raises((ConnectionError, OSError)):
            QueryClient("127.0.0.1", servers[0][1],
                        timeout=1.0).connect(parse_caps_string(CAPS))
        time.sleep(0.5)
        c = QueryClient("127.0.0.1", servers[0][1], timeout=2.0)
        c.connect(parse_caps_string(CAPS))
        c.close()
        net_chaos.clear()

    def test_drop_conn_at_kills_after_n_frames(self, echo3):
        pool, servers = echo3
        _req(pool, "seed")  # open a connection
        net_chaos.drop_conn_at(servers[0][1], 0)
        errors = 0
        for i in range(12):
            try:
                _req(pool, f"dk{i}")
            except Exception:  # noqa: BLE001
                errors += 1
        assert errors == 0, "retries must mask the connection kill"
        assert net_chaos.snapshot()["killed_conns"] >= 1
        net_chaos.clear()

    def test_clear_disarms_hooks(self):
        from nnstreamer_tpu_torch.query import protocol

        net_chaos.delay_ms(59999, 100)
        assert protocol._send_fault_hook is not None
        net_chaos.clear()
        assert protocol._send_fault_hook is None
        assert protocol._connect_fault_hook is None


class TestChaosGate:
    """The CI acceptance gate: 3 replicas, sustained traffic, kill one
    mid-traffic — zero client-visible request errors, evict + readmit.
    Runs under NNS_TSAN=1 in CI (sanitizer gate rides the autouse
    fixture)."""

    def test_kill_one_of_three_under_traffic(self, echo3):
        pool, servers = echo3
        for i in range(6):
            _req(pool, f"warm{i}")
        errors, ok = [], [0]
        stop = threading.Event()

        def traffic(worker):
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    _req(pool, f"{worker}:{i}")
                    ok[0] += 1
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{type(e).__name__}: {e}")
                stop.wait(0.005)

        threads = [threading.Thread(target=traffic, args=(w,),
                                    name=f"fabric:test:traffic{w}")
                   for w in range(2)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.4)
            servers[2][0].stop()  # replica death mid-traffic
            _wait(lambda: pool.snapshot()["evictions"] >= 1)
            time.sleep(0.4)
            pipe, _ = start_echo_server(port=servers[2][1], server_id=812,
                                        model="builtin://scaler?factor=2")
            servers[2][0] = pipe
            _wait(lambda: pool.snapshot()["readmissions"] >= 1)
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=15.0)
        assert not errors, f"client-visible errors: {errors[:5]}"
        assert ok[0] > 50, f"only {ok[0]} requests completed"
        snap = pool.snapshot()
        assert snap["evictions"] >= 1 and snap["readmissions"] >= 1


class TestHybridDiscovery:
    def test_discovered_replica_readmits_on_new_port(self):
        """A hybrid-advertised replica dies and comes back on a NEW
        port; the readmission probe re-resolves through the broker and
        finds it there."""
        from nnstreamer_tpu_torch.query.hybrid import advertise
        from nnstreamer_tpu_torch.query.mqtt import MiniBroker

        broker = MiniBroker()
        pool = _pool()
        pipe, port = start_echo_server(server_id=820,
                                       model="builtin://scaler?factor=2")
        advertise(broker.host, broker.port, "fab-topic", "127.0.0.1", port)
        try:
            pool.add_discovered(broker.host, broker.port, "fab-topic",
                                replica_id="disc")
            out = _req(pool, "d0", value=2.0)
            assert np.allclose(np.asarray(out.tensors[0]), 4.0)
            pipe.stop()
            for i in range(6):  # drive the failure -> eviction
                try:
                    _req(pool, f"dd{i}", timeout=0.5)
                except Exception:  # noqa: BLE001 - single replica is down
                    pass
            _wait(lambda: pool.snapshot()["evictions"] >= 1)
            # back on a DIFFERENT (ephemeral) port + fresh advertisement
            pipe, new_port = start_echo_server(
                server_id=821, model="builtin://scaler?factor=2")
            assert new_port != port
            advertise(broker.host, broker.port, "fab-topic",
                      "127.0.0.1", new_port)
            _wait(lambda: pool.snapshot()["readmissions"] >= 1)
            out = _req(pool, "d1", value=3.0)
            assert np.allclose(np.asarray(out.tensors[0]), 6.0)
        finally:
            pool.close()
            pipe.stop()
            broker.stop()


class TestServiceFabric:
    @pytest.fixture()
    def fab(self):
        mgr = ServiceManager(jitter_seed=0)
        mgr.models.define("slot", {"1": "builtin://scaler?factor=2",
                                   "2": "builtin://scaler?factor=3"},
                          active="1")
        fab = ServiceFabric(
            mgr, "tfab", "tensor_filter framework=torch accelerator=cpu "
            "model=registry://slot",
            CAPS, replicas=3, quarantine_base_s=0.1, health_poll_s=0.05)
        fab.start()
        try:
            yield mgr, fab
        finally:
            fab.stop()
            mgr.shutdown()

    def test_replicas_serve_and_snapshot(self, fab):
        _mgr, fab = fab
        out = fab.request([np.full(4, 2.0, np.float32)], key="a", timeout=8)
        assert np.allclose(np.asarray(out.tensors[0]), 4.0)
        snap = fab.snapshot()
        assert len(snap["replicas"]) == 3
        assert all(r["service"]["ready"] for r in snap["replicas"])

    def test_rolling_swap_under_traffic_zero_errors(self, fab):
        _mgr, fab = fab
        for i in range(6):
            fab.request([np.zeros(4, np.float32)], key=f"w{i}", timeout=30)
        errors, results = [], []
        stop = threading.Event()

        def traffic():
            i = 0
            while not stop.is_set():
                i += 1
                try:
                    out = fab.request([np.ones(4, np.float32)],
                                      key=f"t{i}", timeout=8)
                    results.append(float(np.asarray(out.tensors[0])[0]))
                except Exception as e:  # noqa: BLE001
                    errors.append(str(e))
                stop.wait(0.005)

        t = threading.Thread(target=traffic, name="fabric:test:roll")
        t.start()
        try:
            time.sleep(0.2)
            rolled = fab.rolling_swap("slot", "2")
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=15.0)
        assert not errors, errors[:5]
        assert len(rolled["replicas"]) == 3
        assert results and all(v == 3.0 for v in results[-5:]), results[-5:]

    def test_canary_fraction_then_promote(self, fab):
        mgr, fab = fab
        fab.canary("slot", "2", 0.3)
        vals = []
        for i in range(120):
            out = fab.request([np.ones(4, np.float32)], key=f"c{i}",
                              timeout=8)
            vals.append(float(np.asarray(out.tensors[0])[0]))
        frac = sum(1 for v in vals if v == 3.0) / len(vals)
        assert 0.15 < frac < 0.45, frac
        assert mgr.models.info("slot")["active"] == "1"  # not activated
        fab.promote_canary("slot", "2")
        assert mgr.models.info("slot")["active"] == "2"
        out = fab.request([np.ones(4, np.float32)], key="post", timeout=8)
        assert float(np.asarray(out.tensors[0])[0]) == 3.0
        assert fab.pool.snapshot()["canary"] is None

    def test_canary_cancel_restores_active(self, fab):
        mgr, fab = fab
        fab.canary("slot", "2", 0.4)
        fab.cancel_canary("slot")
        assert mgr.models.info("slot")["active"] == "1"
        vals = [float(np.asarray(
            fab.request([np.ones(4, np.float32)], key=f"z{i}",
                        timeout=8).tensors[0])[0]) for i in range(20)]
        assert all(v == 2.0 for v in vals), sorted(set(vals))

    def test_kill_revive_readmits_on_new_port(self, fab):
        _mgr, fab = fab
        old_port = fab._bound_port(fab.services()[0])
        fab.kill_replica(0)
        errors = 0
        for i in range(15):
            try:
                fab.request([np.ones(4, np.float32)], key=f"k{i}", timeout=8)
            except Exception:  # noqa: BLE001
                errors += 1
        assert errors == 0
        _wait(lambda: fab.pool.snapshot()["evictions"] >= 1)
        fab.revive_replica(0)
        _wait(lambda: fab.pool.snapshot()["readmissions"] >= 1)
        new_port = fab._bound_port(fab.services()[0])
        assert new_port != old_port  # ephemeral port moved; resolver found it


class TestDeadlinePropagation:
    def test_server_sheds_frames_with_exhausted_fabric_budget(self):
        """The per-attempt budget the fabric stamps on each frame
        (meta['fabric']['deadline_s']) is honored by an
        attach_scheduler server: a frame whose budget cannot be met is
        shed with a typed ERROR (RemoteError at the client) instead of
        occupying a batch slot, while a frame with real budget serves."""
        from nnstreamer_tpu_torch.core import Buffer, Caps
        from nnstreamer_tpu_torch.query.client import QueryClient, RemoteError
        from nnstreamer_tpu_torch.query.server import QueryServer
        from nnstreamer_tpu_torch.serving import Scheduler

        caps = Caps.new("other/tensors")
        server = QueryServer(port=0, caps=caps)
        sched = Scheduler(lambda x: (x + 1,), bucket_sizes=(1, 2),
                          max_wait_s=0.05, name="t-fabric-deadline")
        server.attach_scheduler(sched)
        c = QueryClient("127.0.0.1", server.port)
        try:
            c.connect(caps)
            # healthy budget: the answer comes back
            good = Buffer([np.zeros((1, 3), np.float32)])
            good.meta["fabric"] = {"deadline_s": 30.0, "key": "a",
                                   "attempt": 0}
            assert c.request(good, timeout=30.0) is not None
            # exhausted budget: typed shed, not a slot + silent timeout
            bad = Buffer([np.zeros((1, 3), np.float32)])
            bad.meta["fabric"] = {"deadline_s": 0.0, "key": "b",
                                  "attempt": 1}
            with pytest.raises(RemoteError):
                c.request(bad, timeout=10.0)
        finally:
            c.close()
            server.stop()
            sched.close()
