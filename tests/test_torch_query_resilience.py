"""Query-layer failure handling in both packages: the mirror of
tests/test_query_resilience.py — reconnect with backoff after a server
restart, the reconnect window's edges, and a shard branch's death
mid-stream.

Each case runs the same client line against the same echo server in
nnstreamer_tpu (``ref``) and in the port (``port``; its filters get
``accelerator=cpu``) and holds the reference's relations on each side.
The hybrid re-discovery case fails in some runs of the reference
(ROADMAP.md, the unsteady list), so there the port is held to the
relation and compared with what the reference's own run gave, where
that run completed, not with the reference test's assertion. Its
resumed answers are counted by value: an answer to a frame pushed
before the move can arrive after it."""
import time

import numpy as np
import pytest

from torch_mirror import SIDES, host, mod, parse

VEC = "appsrc name=in caps=other/tensors,format=static,dimensions=4,types=float32 "


def start_echo_server(side, port=0, model="builtin://passthrough",
                      server_id=0):
    """``side``'s serversrc ! filter ! serversink (the reference echo
    test's server); (pipeline, bound port)."""
    pipe = parse(side,
                 f"tensor_query_serversrc name=ssrc id={server_id} "
                 f"port={port} caps=other/tensors,format=static,"
                 "dimensions=4,types=float32 "
                 f"! tensor_filter framework=jax model={model} "
                 f"! tensor_query_serversink id={server_id}")
    pipe.play()
    src = pipe.get("ssrc")
    deadline = time.monotonic() + 5
    while src.bound_port == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    return pipe, src.bound_port


def _client(side, props, out):
    pipe = parse(side, VEC + f"! tensor_query_client {props} "
                 "! tensor_sink name=out")
    pipe.get("out").connect(out.append)
    return pipe


def _push_until(src, out, want, value=1.0, timeout=10.0, dims=4):
    """Keep pushing frames until ``want`` responses arrive (frames sent
    while a link is down are dropped by design)."""
    deadline = time.monotonic() + timeout
    i = 0
    while len(out) < want and time.monotonic() < deadline:
        src.push_buffer(np.full(dims, value, np.float32))
        i += 1
        time.sleep(0.02)
    return i


def _last(out) -> np.ndarray:
    return host(out[-1].tensors[0])


def _drain_types(pipe):
    types = []
    msg = pipe.bus.pop(timeout=0)
    while msg is not None:
        types.append(msg.type.name)
        msg = pipe.bus.pop(timeout=0)
    return types


@pytest.mark.parametrize("side", SIDES)
class TestReconnect:
    def test_server_restart_mid_stream(self, side):
        """Kill the server, restart it on the same port; the client stream
        must resume without EOS (frames during downtime are dropped)."""
        server, port = start_echo_server(side, server_id=50)
        out = []
        client = _client(side, f"host=127.0.0.1 port={port} "
                         "reconnect-window=15 max-reconnect-delay=0.5", out)
        try:
            client.play()
            src = client.get("in")
            _push_until(src, out, want=3)
            assert len(out) >= 3, "no responses before restart"
            n_before = len(out)

            server.stop()  # connection drops
            time.sleep(0.3)
            server, port2 = start_echo_server(side, port=port, server_id=51)
            assert port2 == port

            _push_until(src, out, want=n_before + 3, value=7.0, timeout=15.0)
            assert len(out) >= n_before + 3, \
                "stream did not resume after restart"
            # resumed responses are real data from the new server
            assert np.allclose(_last(out), 7.0)
            # no EOS/ERROR was posted: the stream survived
            types = _drain_types(client)
            assert "EOS" not in types and "ERROR" not in types, types
        finally:
            client.stop()
            server.stop()

    def test_no_reconnect_ends_stream(self, side):
        """reconnect=false restores the old behavior: EOS on first drop."""
        MessageType = mod(side, "core").MessageType
        server, port = start_echo_server(side, server_id=52)
        out = []
        client = _client(side, f"host=127.0.0.1 port={port} reconnect=false",
                         out)
        try:
            client.play()
            _push_until(client.get("in"), out, want=1)
            server.stop()
            msg = client.bus.wait_for((MessageType.EOS,), timeout=10)
            assert msg is not None, \
                "expected EOS after disconnect with reconnect=false"
        finally:
            client.stop()
            server.stop()

    def test_reconnect_window_expiry_posts_error(self, side):
        """Server never comes back: the client gives up after the window
        and posts a real error instead of hanging."""
        MessageType = mod(side, "core").MessageType
        server, port = start_echo_server(side, server_id=53)
        out = []
        client = _client(side, f"host=127.0.0.1 port={port} "
                         "reconnect-window=1.5 max-reconnect-delay=0.3 "
                         "timeout=1", out)
        try:
            client.play()
            _push_until(client.get("in"), out, want=1)
            server.stop()
            msg = client.bus.wait_for((MessageType.ERROR,), timeout=15)
            assert msg is not None, \
                "expected ERROR after reconnect window expiry"
            assert "not re-established" in msg.data.get("error", "")
        finally:
            client.stop()
            server.stop()


def _hybrid_run(side):
    """The hybrid re-discovery scenario on ``side``: (responses before
    the move, responses of the moved server, last value, bus message
    types, the values answered after the move). A response of the moved server is one carrying 5.0: frames of
    1.0 pushed before the move can still be answered after it (in flight
    when the old server stopped), and are not counted as resumed."""
    hybrid = mod(side, "query.hybrid")
    broker = mod(side, "query.mqtt").MiniBroker()
    server, port = start_echo_server(side, server_id=56)
    hybrid.advertise(broker.host, broker.port, "rw-topic", "127.0.0.1", port)
    out = []
    client = _client(side, f"connect-type=HYBRID host={broker.host} "
                     f"port={broker.port} topic=rw-topic "
                     "reconnect-window=15 max-reconnect-delay=0.3 timeout=2",
                     out)
    try:
        client.play()
        src = client.get("in")
        _push_until(src, out, want=2)
        n_before = len(out)
        server.stop()  # the advertised address is now dead
        server, new_port = start_echo_server(side, server_id=57)
        assert new_port != port
        hybrid.advertise(broker.host, broker.port, "rw-topic",
                         "127.0.0.1", new_port)
        resumed = _push_until_value(src, out, 5.0, want=3, timeout=15.0)
        last = float(_last(out).reshape(-1)[0]) if out else None
        after = [float(host(b.tensors[0]).reshape(-1)[0])
                 for b in out[n_before:]]
        return n_before, resumed, last, _drain_types(client), after
    finally:
        client.stop()
        server.stop()
        broker.stop()


def _push_until_value(src, out, value, want, timeout):
    """Push frames of ``value`` until ``want`` responses carry it; return
    how many do."""
    def count():
        return sum(1 for b in list(out)
                   if float(host(b.tensors[0]).reshape(-1)[0]) == value)

    deadline = time.monotonic() + timeout
    while count() < want and time.monotonic() < deadline:
        src.push_buffer(np.full(4, value, np.float32))
        time.sleep(0.02)
    return count()


class TestReconnectWindowEdges:
    """Reconnect-window edge cases: hybrid re-discovery onto a NEW port
    mid-window, success landing right at the window's edge, and stop()
    interrupting the backoff wait."""

    def test_hybrid_rediscovery_new_port_mid_window(self):
        """HYBRID client: the server dies and comes back on a DIFFERENT
        port, re-advertised through the broker. The reconnect path
        re-discovers on every attempt, so the stream resumes on the new
        address without a pipeline restart. The port must resume: three
        answers of the moved server, the last answer its own. The
        reference's run is compared only where it completed (it is
        unsteady: ROADMAP.md §C); then both resumed with the same
        value."""
        port = _hybrid_run("port")
        assert port[0] >= 2 and port[1] >= 3, \
            f"port stream did not resume on new port: {port}"
        assert port[2] == 5.0
        assert "ERROR" not in port[3], port
        try:
            ref = _hybrid_run("ref")
        except Exception:   # noqa: BLE001 — the reference's own run failed
            ref = None
        if ref is not None and ref[1] >= 3:
            # both answered the moved server's frames, and nothing but
            # echoes of the frames each sent
            assert set(port[4]) <= {1.0, 5.0} and set(ref[4]) <= {1.0, 5.0}

    @pytest.mark.parametrize("side", SIDES)
    def test_reconnect_success_at_window_edge(self, side):
        """The server returns just before the reconnect window closes:
        the last in-window attempt must still succeed (no premature
        give-up), and no ERROR is posted."""
        server, port = start_echo_server(side, server_id=58)
        out = []
        client = _client(side, f"host=127.0.0.1 port={port} "
                         "reconnect-window=3.0 max-reconnect-delay=0.3 "
                         "timeout=1", out)
        try:
            client.play()
            src = client.get("in")
            _push_until(src, out, want=1)
            n_before = len(out)
            server.stop()
            # hold the outage until ~80% of the window is spent, then
            # come back: the remaining attempts land inside the window
            time.sleep(2.3)
            server, port2 = start_echo_server(side, port=port, server_id=59)
            assert port2 == port
            _push_until(src, out, want=n_before + 2, value=4.0, timeout=15.0)
            assert len(out) >= n_before + 2, "edge-of-window reconnect failed"
            assert "ERROR" not in _drain_types(client)
        finally:
            client.stop()
            server.stop()

    @pytest.mark.parametrize("side", SIDES)
    def test_stop_interrupts_backoff_promptly(self, side):
        """stop() during the reconnect backoff must return promptly (the
        stopping event wakes the wait) — not after riding out
        max-reconnect-delay or the window."""
        server, port = start_echo_server(side, server_id=60)
        out = []
        client = _client(side, f"host=127.0.0.1 port={port} "
                         "reconnect-window=30 max-reconnect-delay=8 "
                         "timeout=1", out)
        try:
            client.play()
            _push_until(client.get("in"), out, want=1)
            server.stop()
            # let the pull loop notice the drop and enter backoff (first
            # attempt fails fast: nothing listens on the port)
            time.sleep(0.8)
            t0 = time.monotonic()
            client.stop()
            elapsed = time.monotonic() - t0
            assert elapsed < 3.0, (
                f"stop() took {elapsed:.1f}s — backoff was not interrupted")
        finally:
            client.stop()
            server.stop()


class TestShardBranchFailure:
    @pytest.mark.parametrize("side", SIDES)
    def test_surviving_branch_keeps_streaming(self, side):
        """Two query workers behind tensor_shard; one dies permanently.
        The other branch keeps delivering (dead branch's frames are
        declared lost once the re-join buffer fills)."""
        s0, p0 = start_echo_server(side, server_id=54)
        s1, p1 = start_echo_server(side, server_id=55)
        out = []
        client = parse(
            side, VEC + "! tensor_shard name=s "
            f"s.src_0 ! tensor_query_client host=127.0.0.1 port={p0} "
            "reconnect-window=2 max-reconnect-delay=0.3 timeout=1 ! u.sink_0 "
            f"s.src_1 ! tensor_query_client host=127.0.0.1 port={p1} "
            "reconnect-window=2 max-reconnect-delay=0.3 timeout=1 ! u.sink_1 "
            "tensor_unshard name=u max-buffered=4 ! tensor_sink name=out")
        client.get("out").connect(out.append)
        try:
            client.play()
            src = client.get("in")
            _push_until(src, out, want=4)
            assert len(out) >= 4
            n_before = len(out)
            s1.stop()  # branch 1 dies and never returns
            # keep the stream flowing; branch 0 must continue delivering
            deadline = time.monotonic() + 20
            i = 0
            while len(out) < n_before + 4 and time.monotonic() < deadline:
                src.push_buffer(np.full(4, 9.0, np.float32))
                i += 1
                time.sleep(0.02)
            assert len(out) >= n_before + 4, (
                f"stream stalled after branch death ({len(out)} of "
                f"{n_before + 4} wanted, {i} pushed)")
            assert np.allclose(_last(out), 9.0)
        finally:
            client.stop()
            s0.stop()
            s1.stop()
