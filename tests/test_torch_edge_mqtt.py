"""The port's edge pub/sub, MQTT and hybrid discovery (``query/{edge,mqtt,
hybrid}.py``, ``elements/mqtt.py``, ``utils/ntp.py``) against
nnstreamer_tpu's.

* the edge cases of the reference's ``tests/test_query.py``
  (``TestEdgePubSub``) and the cases of ``tests/test_hybrid.py``,
  ``tests/test_mqtt_broker_integration.py`` and
  ``tests/test_mqtt_clock_sync.py`` on the port;
* mixed packages: a reference ``edgesink`` feeding a port ``edgesrc``, a
  reference ``mqttsink`` feeding a port ``mqttsrc`` through one embedded
  broker (and back), an advertisement by one package discovered by the
  other — the bytes equal on both sides.

Every wait is bounded."""
import shutil
import socket
import struct
import subprocess
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu.query import hybrid as r_hybrid
from nnstreamer_tpu.query import mqtt as r_mqtt
from nnstreamer_tpu.runtime.parse import parse_launch as r_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.elements import mqtt as mqtt_el
from nnstreamer_tpu_torch.query import mqtt as mqtt_mod
from nnstreamer_tpu_torch.query.hybrid import (ADDR_TOPIC, advertise, discover,
                                               withdraw)
from nnstreamer_tpu_torch.query.mqtt import MiniBroker
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.utils.ntp import (NTP_DELTA, EpochClock,
                                            parse_servers, sntp_epoch_us)

CAPS = "other/tensors,format=static,dimensions=4,types=float32"


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert cond()


def _bound(pipe, name):
    _wait(lambda: pipe.get(name).bound_port != 0, 5)
    return pipe.get(name).bound_port


def _first(b) -> float:
    return float(np.asarray(b.as_numpy().tensors[0]).reshape(-1)[0])


# ---------------------------------------------------------------------------
# edge pub/sub (reference tests/test_query.py::TestEdgePubSub)
# ---------------------------------------------------------------------------

class TestEdgePubSub:
    def test_topic_stream(self):
        pub = parse_launch(
            "tensor_src num-buffers=200 dimensions=2 types=float32 "
            "pattern=counter framerate=100 ! edgesink name=pub topic=sensor "
            "port=0")
        pub.play()
        port = _bound(pub, "pub")
        try:
            sub = parse_launch(
                f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=sensor "
                "! tensor_sink name=out")
            out = []
            sub.get("out").connect(out.append)
            sub.play()
            _wait(lambda: len(out) >= 5)
            sub.stop()
            vals = [_first(b) for b in out]
            assert vals == sorted(vals)
        finally:
            pub.stop()

    def test_edgesrc_num_buffers(self):
        pub = parse_launch(
            "tensor_src num-buffers=200 dimensions=2 types=float32 "
            "pattern=counter framerate=100 ! edgesink name=pub topic=capped "
            "port=0")
        pub.play()
        port = _bound(pub, "pub")
        try:
            sub = parse_launch(
                f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=capped "
                "num-buffers=3 ! tensor_sink name=out")
            out = []
            sub.get("out").connect(out.append)
            sub.run(timeout=10)
            sub.stop()
            assert len(out) == 3
        finally:
            pub.stop()

    def test_edge_mqtt_connect_type(self):
        broker = mqtt_mod.get_embedded_broker(0)
        try:
            pub = parse_launch(
                "tensor_src num-buffers=300 dimensions=2 types=float32 "
                "pattern=counter framerate=100 ! edgesink topic=mq "
                f"connect-type=MQTT dest-host={broker.host} "
                f"dest-port={broker.port}")
            pub.play()
            sub = parse_launch(
                f"edgesrc connect-type=MQTT dest-host={broker.host} "
                f"dest-port={broker.port} topic=mq ! tensor_sink name=out")
            out = []
            sub.get("out").connect(out.append)
            sub.play()
            _wait(lambda: len(out) >= 5)
            sub.stop()
            pub.stop()
            vals = [_first(b) for b in out]
            assert vals == sorted(vals)
        finally:
            mqtt_mod.release_embedded_broker(broker)

    def test_edgesink_wait_connection(self):
        pub = parse_launch(
            "tensor_src num-buffers=5 dimensions=2 types=float32 "
            "pattern=counter framerate=50 ! edgesink name=pub topic=held "
            "port=0 wait-connection=true connection-timeout=10")
        pub.play()
        port = _bound(pub, "pub")
        try:
            time.sleep(0.3)   # frames are produced but held, not dropped
            sub = parse_launch(
                f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=held "
                "! tensor_sink name=out")
            out = []
            sub.get("out").connect(out.append)
            sub.play()
            _wait(lambda: len(out) >= 5)
            sub.stop()
            assert len(out) == 5 and _first(out[0]) == 0.0
        finally:
            pub.stop()

    def test_edgesink_wait_connection_timeout_errors(self):
        pub = parse_launch(
            "tensor_src num-buffers=3 dimensions=2 types=float32 "
            "framerate=50 ! edgesink topic=nobody port=0 wait-connection=true "
            "connection-timeout=0.2")
        pub.play()
        msg = pub.bus.wait_for((MessageType.ERROR,), timeout=5)
        pub.stop()
        assert msg is not None and "no subscriber" in msg.data["error"]

    def test_unknown_topic(self):
        pub = parse_launch(
            "tensor_src num-buffers=50 dimensions=1 framerate=50 "
            "! edgesink name=pub topic=real port=0")
        pub.play()
        port = _bound(pub, "pub")
        try:
            sub = parse_launch(
                f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=nope "
                "! tensor_sink name=out")
            sub.play()
            msg = sub.bus.wait_for((MessageType.ERROR,), timeout=5)
            sub.stop()
            assert msg is not None and "unknown topic" in msg.data["error"]
        finally:
            pub.stop()


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_edge_across_packages_bytes_equal(publisher):
    """One package's edgesink feeds the other's edgesrc; the subscriber
    sees the publisher's frames byte for byte."""
    frames = [np.random.default_rng(i).standard_normal(4).astype(np.float32)
              for i in range(4)]
    pub_parse, sub_parse = ((r_parse_launch, parse_launch)
                            if publisher == "reference"
                            else (parse_launch, r_parse_launch))
    pub = pub_parse(f"appsrc name=in caps={CAPS} ! edgesink name=pub "
                    "topic=x port=0 wait-connection=true "
                    "connection-timeout=10")
    pub.play()
    port = _bound(pub, "pub")
    sub = sub_parse(f"edgesrc dest-host=127.0.0.1 dest-port={port} topic=x "
                    "num-buffers=4 ! tensor_sink name=out")
    out = []
    sub.get("out").connect(out.append)
    try:
        pub.get("in").push_buffer(frames[0])   # sets the topic's caps
        sub.play()
        for f in frames[1:]:
            pub.get("in").push_buffer(f)
        _wait(lambda: len(out) >= 4)
    finally:
        sub.stop()
        pub.stop()
    for b, f in zip(out, frames):
        assert np.asarray(b.as_numpy().tensors[0]).tobytes() == f.tobytes()


# ---------------------------------------------------------------------------
# hybrid discovery (reference tests/test_hybrid.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def broker():
    b = MiniBroker()
    yield b
    b.stop()


class TestDiscovery:
    def test_advertise_discover_roundtrip(self, broker):
        advertise(broker.host, broker.port, "cam0", "10.0.0.5", 5001)
        assert discover(broker.host, broker.port, "cam0") == ("10.0.0.5", 5001)

    def test_retained_for_late_subscriber(self, broker):
        advertise(broker.host, broker.port, "late", "h", 7)
        time.sleep(0.05)
        assert discover(broker.host, broker.port, "late") == ("h", 7)

    def test_discover_timeout_when_unadvertised(self, broker):
        with pytest.raises(ConnectionError, match="no data server"):
            discover(broker.host, broker.port, "ghost", timeout=0.3)

    def test_withdraw_clears(self, broker):
        advertise(broker.host, broker.port, "gone", "h", 9)
        withdraw(broker.host, broker.port, "gone")
        with pytest.raises(ConnectionError):
            discover(broker.host, broker.port, "gone", timeout=0.3)

    def test_advertise_then_withdraw_applied_in_order(self, broker):
        """Each call returns only once the broker applied its retained
        PUBLISH (the PINGREQ/PINGRESP round trip), so a withdraw never
        lands before the advertise it follows."""
        slot = ADDR_TOPIC.format(topic="order")
        for i in range(200):
            advertise(broker.host, broker.port, "order", "h", 1000 + i)
            assert broker._retained.get(slot) == f"h:{1000 + i}".encode()
            withdraw(broker.host, broker.port, "order")
            assert slot not in broker._retained

    def test_ipv6_host_parses(self, broker):
        advertise(broker.host, broker.port, "v6", "::1", 5001)
        assert discover(broker.host, broker.port, "v6") == ("::1", 5001)

    def test_empty_topic_fails_fast(self, broker):
        pipe = parse_launch(
            f"appsrc name=in caps={CAPS} ! tensor_query_client "
            f"connect-type=HYBRID host={broker.host} port={broker.port} "
            "! tensor_sink name=out")
        t0 = time.monotonic()
        pipe.play()
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
        pipe.stop()
        assert msg is not None and "topic" in str(msg.data)
        assert time.monotonic() - t0 < 5

    def test_live_publish_resolves_waiting_discover(self, broker):
        def late_advertise():
            time.sleep(0.2)
            advertise(broker.host, broker.port, "race", "hh", 42)

        t = threading.Thread(target=late_advertise, daemon=True)
        t.start()
        assert discover(broker.host, broker.port, "race", timeout=5) == \
            ("hh", 42)
        t.join(timeout=5)

    @pytest.mark.parametrize("advertiser", ["reference", "port"])
    def test_discovery_across_packages(self, broker, advertiser):
        """Both packages publish the same retained advertisement: one
        package's server is found by the other's client."""
        adv, disc = ((r_hybrid.advertise, discover)
                     if advertiser == "reference"
                     else (advertise, r_hybrid.discover))
        adv(broker.host, broker.port, "mixed", "10.1.2.3", 6001)
        assert disc(broker.host, broker.port, "mixed") == ("10.1.2.3", 6001)


def _start_hybrid_server(broker, topic, server_id,
                         model="builtin://scaler?factor=3"):
    pipe = parse_launch(
        f"tensor_query_serversrc name=ssrc id={server_id} port=0 "
        f"connect-type=HYBRID dest-host={broker.host} "
        f"dest-port={broker.port} topic={topic} caps={CAPS} "
        f"! tensor_filter framework=torch accelerator=cpu model={model} "
        f"! tensor_query_serversink id={server_id}")
    pipe.play()
    _bound(pipe, "ssrc")
    return pipe


class TestHybridQueryOffload:
    def test_offload_via_discovery(self, broker):
        server = _start_hybrid_server(broker, "offload", 60)
        try:
            client = parse_launch(
                f"appsrc name=in caps={CAPS} ! tensor_query_client "
                f"connect-type=HYBRID host={broker.host} port={broker.port} "
                "topic=offload ! tensor_sink name=out max-stored=8")
            out = []
            client.get("out").connect(out.append)
            client.play()
            src = client.get("in")
            for i in range(3):
                src.push_buffer(np.full(4, i, np.float32))
            src.end_of_stream()
            _wait(lambda: len(out) >= 3)
            client.stop()
            np.testing.assert_allclose(np.asarray(out[2].tensors[0]), 6.0)
        finally:
            server.stop()

    def test_client_rediscovers_moved_server(self, broker):
        server = _start_hybrid_server(broker, "moving", 61)
        client = parse_launch(
            f"appsrc name=in caps={CAPS} ! tensor_query_client name=qc "
            f"connect-type=HYBRID host={broker.host} port={broker.port} "
            "topic=moving reconnect-window=15 ! tensor_sink name=out "
            "max-stored=16")
        out = []
        client.get("out").connect(out.append)
        client.play()
        src = client.get("in")
        try:
            src.push_buffer(np.full(4, 1.0, np.float32))
            _wait(lambda: len(out) >= 1)
            port_a = server.get("ssrc").bound_port
            server.stop()
            server = _start_hybrid_server(broker, "moving", 62)
            assert server.get("ssrc").bound_port != port_a
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                src.push_buffer(np.full(4, 5.0, np.float32))
                if len(out) >= 2:
                    break
                time.sleep(0.3)
            _wait(lambda: len(out) >= 2)
            np.testing.assert_allclose(np.asarray(out[-1].tensors[0]), 15.0)
        finally:
            client.stop()
            server.stop()


class TestHybridEdge:
    def test_edge_pubsub_via_discovery(self, broker):
        pub = parse_launch(
            "tensor_src num-buffers=30 framerate=30/1 dimensions=4 "
            "types=float32 pattern=counter ! edgesink name=es "
            "connect-type=HYBRID topic=sensor0 port=0 "
            f"dest-host={broker.host} dest-port={broker.port}")
        pub.play()
        _bound(pub, "es")
        try:
            sub = parse_launch(
                f"edgesrc connect-type=HYBRID topic=sensor0 "
                f"dest-host={broker.host} dest-port={broker.port} "
                "! tensor_sink name=out max-stored=8")
            out = []
            sub.get("out").connect(out.append)
            sub.play()
            _wait(lambda: len(out) >= 3)
            sub.stop()
            vals = [_first(b) for b in out]
            assert vals == sorted(vals)
        finally:
            pub.stop()

    def test_bad_connect_type_rejected(self):
        with pytest.raises(ValueError, match="connect-type"):
            parse_launch(f"appsrc caps={CAPS} ! tensor_query_client "
                         "connect-type=ZIGBEE ! tensor_sink")

    def test_aitt_constructs_but_fails_at_connect(self):
        from nnstreamer_tpu_torch.query.elements import TensorQueryClient

        pipe = parse_launch(f"appsrc caps={CAPS} ! tensor_query_client "
                            "name=c connect-type=AITT ! tensor_sink")
        client = pipe.get("c")
        assert isinstance(client, TensorQueryClient)
        with pytest.raises(Exception, match="AITT"):
            client._new_client()
        pipe.stop()


# ---------------------------------------------------------------------------
# mqttsink / mqttsrc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("publisher", ["port", "reference"])
def test_mqtt_elements_across_packages_bytes_equal(publisher):
    """mqttsink → one embedded broker → mqttsrc, either package on either
    end: frames and caps arrive byte for byte."""
    b = MiniBroker()
    pub_parse, sub_parse = ((parse_launch, r_parse_launch)
                            if publisher == "port"
                            else (r_parse_launch, parse_launch))
    frames = [np.random.default_rng(i).standard_normal(4).astype(np.float32)
              for i in range(3)]
    sub = sub_parse(f"mqttsrc host=127.0.0.1 port={b.port} sub-topic=nns/x "
                    "num-buffers=3 timeout=15 ! tensor_sink name=out")
    got = []
    sub.get("out").connect(got.append)
    pub = pub_parse(f"appsrc name=in caps={CAPS} ! mqttsink host=127.0.0.1 "
                    f"port={b.port} pub-topic=nns/x broker=external")
    try:
        pub.play()
        pub.get("in").push_buffer(frames[0])   # retained caps first
        sub.play()
        i = 0
        deadline = time.monotonic() + 15
        # mqtt is QoS 0 pub/sub: publish until the subscriber has three
        while len(got) < 3 and time.monotonic() < deadline:
            pub.get("in").push_buffer(frames[i % 3])
            i += 1
            time.sleep(0.05)
    finally:
        sub.stop()
        pub.stop()
        b.stop()
    assert len(got) >= 3
    want = {f.tobytes() for f in frames}
    for g in got:
        a = np.asarray(g.as_numpy().tensors[0])
        assert a.dtype == np.float32 and a.tobytes() in want


MOSQUITTO = shutil.which("mosquitto")


@pytest.mark.skipif(MOSQUITTO is None, reason="mosquitto broker not installed")
def test_pub_sub_roundtrip_through_a_real_broker(tmp_path):
    """mqttsink → mosquitto → mqttsrc (the reference's
    tests/test_mqtt_broker_integration.py)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    conf = tmp_path / "mosquitto.conf"
    conf.write_text(f"listener {port} 127.0.0.1\nallow_anonymous true\n")
    proc = subprocess.Popen([MOSQUITTO, "-c", str(conf)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        _wait(lambda: _can_connect(port), 5)
        sub = parse_launch(
            f"mqttsrc host=127.0.0.1 port={port} sub-topic=nns/t0 "
            "num-buffers=3 timeout=15 ! tensor_sink name=out")
        got = []
        sub.get("out").connect(got.append)
        pub = parse_launch(
            f"appsrc name=in caps={CAPS} ! mqttsink host=127.0.0.1 "
            f"port={port} pub-topic=nns/t0 broker=external")
        pub.play()
        sub.play()
        deadline = time.monotonic() + 15
        i = 0
        while len(got) < 3 and time.monotonic() < deadline:
            pub.get("in").push_buffer(np.full(4, float(i), np.float32))
            i += 1
            time.sleep(0.05)
        sub.stop()
        pub.stop()
        assert len(got) >= 3
    finally:
        proc.terminate()
        proc.wait(timeout=5)


def _can_connect(port) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
        return True
    except OSError:
        return False


def test_mqtt_packets_equal_the_reference():
    """The MQTT 3.1.1 framing gives the reference's bytes: remaining
    lengths at each varint boundary, strings, one PUBLISH packet, and the
    topic filter rules."""
    for v in (0, 127, 128, 16383, 16384, 2097151, 2097152):
        assert mqtt_mod._encode_len(v) == r_mqtt._encode_len(v)
    assert mqtt_mod._mqtt_str(b"nns/x") == r_mqtt._mqtt_str(b"nns/x")
    wire = []
    for mod in (mqtt_mod, r_mqtt):
        a, b = socket.socketpair()
        b.settimeout(5)
        try:
            mod._send_packet(a, 3, mod._mqtt_str(b"t/1") + b"\x00" * 300)
            a.close()
            chunks = []
            while True:
                c = b.recv(4096)
                if not c:
                    break
                chunks.append(c)
            wire.append(b"".join(chunks))
        finally:
            b.close()
    assert wire[0] == wire[1]
    for pat, topic in (("a/+/c", "a/b/c"), ("a/#", "a/b/c"), ("a/b", "a/c"),
                       ("#", "x"), ("+/b", "a/b/c")):
        assert mqtt_mod.topic_matches(pat, topic) == \
            r_mqtt.topic_matches(pat, topic)


# ---------------------------------------------------------------------------
# clock sync (reference tests/test_mqtt_clock_sync.py)
# ---------------------------------------------------------------------------

class FakeNtpServer:
    """UDP responder: a mode-4 reply whose transmit time is ``clock()``."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while self._running:
            try:
                _, addr = self._sock.recvfrom(256)
            except socket.timeout:
                continue
            except OSError:
                return
            t = self._clock()
            reply = bytearray(48)
            reply[0] = 0x1C
            struct.pack_into("!II", reply, 40,
                             int(t) + NTP_DELTA, int((t % 1.0) * (1 << 32)))
            try:
                self._sock.sendto(bytes(reply), addr)
            except OSError:
                return

    def stop(self):
        self._running = False
        self._thread.join(timeout=2)
        self._sock.close()


@pytest.fixture()
def ntp_server():
    s = FakeNtpServer()
    yield s
    s.stop()


class TestSntp:
    def test_query_returns_epoch(self, ntp_server):
        got = sntp_epoch_us("127.0.0.1", ntp_server.port)
        assert abs(got - time.time() * 1e6) < 200_000

    def test_bogus_reply_rejected(self):
        srv = FakeNtpServer(clock=lambda: -1e9)
        try:
            with pytest.raises(ValueError):
                sntp_epoch_us("127.0.0.1", srv.port)
        finally:
            srv.stop()

    def test_parse_servers_like_the_reference(self):
        from nnstreamer_tpu.utils.ntp import parse_servers as r_parse

        for text in ("a:123, b ,c:999", "", "pool.ntp.org:123"):
            assert parse_servers(text) == r_parse(text)


class TestEpochClock:
    def test_corrects_skewed_wall(self, ntp_server):
        clock = EpochClock(f"127.0.0.1:{ntp_server.port}",
                           wall=lambda: time.time() - 7.5)
        assert clock.sync()
        assert abs(clock.epoch_us() - time.time() * 1e6) < 300_000

    def test_no_server_falls_back_to_wall(self):
        clock = EpochClock("127.0.0.1:1", timeout=0.2)
        assert not clock.sync()
        assert abs(clock.epoch_us() - time.time() * 1e6) < 200_000


def _skewed_clock_factory(ntp_port, skews):
    def make(element):
        skew = skews.get(element.name, 0.0)
        clock = EpochClock(
            f"127.0.0.1:{ntp_port}" if element.props["ntp_sync"] else "",
            wall=lambda: time.time() + skew)
        if element.props["ntp_sync"]:
            assert clock.sync(), "fake NTP server did not answer"
        return clock
    return make


def _run_pub_sub(monkeypatch, ntp_port, skews, ntp_sync):
    monkeypatch.setattr(mqtt_el, "_epoch_clock",
                        _skewed_clock_factory(ntp_port, skews))
    sync = "true" if ntp_sync else "false"
    pub = parse_launch(
        "tensor_src num-buffers=40 framerate=20/1 dimensions=4 "
        "types=float32 pattern=counter ! mqttsink name=pub "
        f"pub-topic=clocksync broker=embedded port=0 ntp-sync={sync}")
    pub.play()
    port = pub.get("pub").bound_port
    time.sleep(0.5)
    sub = parse_launch(
        f"mqttsrc name=sub port={port} sub-topic=clocksync ntp-sync={sync} "
        "! tensor_sink name=out max-stored=0")
    got = []
    sub.get("out").connect(got.append)
    sub.play()
    _wait(lambda: len(got) >= 10)
    pub.stop()
    sub.stop()
    return got


class TestCrossHostAlignment:
    def test_skewed_hosts_reconstruct_pts_with_ntp(self, monkeypatch,
                                                   ntp_server):
        got = _run_pub_sub(monkeypatch, ntp_server.port,
                           {"pub": -4.0, "sub": +3.0}, ntp_sync=True)
        pts = [b.pts for b in got if b.pts is not None]
        assert len(pts) >= 5
        assert all(-0.1 <= p <= 5.0 for p in pts), pts[:5]
        assert pts == sorted(pts)
        lats = [b.meta.get("mqtt_latency_us") for b in got]
        assert any(lat is not None and -100_000 < lat < 2_000_000
                   for lat in lats)

    def test_skewed_hosts_without_ntp_lose_timestamps(self, monkeypatch,
                                                      ntp_server):
        got = _run_pub_sub(monkeypatch, ntp_server.port,
                           {"pub": -4.0, "sub": +3.0}, ntp_sync=False)
        assert all(b.pts is None for b in got)
