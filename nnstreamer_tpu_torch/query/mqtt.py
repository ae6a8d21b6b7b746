"""Minimal MQTT 3.1.1 transport: client + in-process mini-broker.

The counterpart of nnstreamer_tpu's ``query/mqtt.py``.

Reference analog: ``gst/mqtt/`` (3449 LoC) uses the external Eclipse Paho
``MQTTAsync`` client against an external broker. We carry no third-party
dependency: this is an own, small MQTT 3.1.1 implementation covering the
packet types the elements need (CONNECT/CONNACK, PUBLISH QoS0,
SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK, PINGREQ/PINGRESP, DISCONNECT) —
wire-compatible with a real broker (mosquitto etc.), plus a loopback
:class:`MiniBroker` so tests don't need one (the reference skips its mqtt
tests when no broker is running; see tests/check_broker.sh).

QoS0-only by design: tensor streams are realtime; retransmission of stale
frames is load without value (the reference publishes QoS-default too).
Retained messages are supported — the elements use a retained caps topic
for stream negotiation.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.log import logger
from ..utils.threads import ThreadRegistry


def _closer(conn: socket.socket):
    """Idempotent wake+close for a socket a worker thread is recv-ing on
    (plain close() does not reliably wake a blocked recv; shutdown does)."""
    def close() -> None:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        conn.close()
    return close


# MQTT 3.1.1 [2.2.3]: remaining length is a 4-digit varint, so the
# protocol itself caps a packet at 256 MiB - 1; enforcing it here bounds
# what a hostile peer can make _read_packet allocate
MQTT_MAX_PACKET = 268_435_455

# a silent peer must not park a broker serve thread forever: the CONNECT
# packet has this long to arrive before the connection is dropped
MQTT_CONNECT_DEADLINE_S = 10.0

# packet types (high nibble of the fixed header)
CONNECT, CONNACK = 1, 2
PUBLISH = 3
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14


def _encode_len(n: int) -> bytes:
    out = bytearray()
    while True:
        digit = n % 128
        n //= 128
        out.append(digit | (0x80 if n else 0))
        if not n:
            # nnlint: disable=NNL405 — a <=4-byte varint length field, not
            # a frame payload: the copy is the owning-bytes conversion of
            # a scratch bytearray, amortized to nothing
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            c = sock.recv(n)
        except OSError:
            return None
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _read_packet(sock: socket.socket) -> Optional[Tuple[int, int, bytes]]:
    """Returns (type, flags, payload) or None on EOF."""
    h = _read_exact(sock, 1)
    if h is None:
        return None
    ptype, flags = h[0] >> 4, h[0] & 0x0F
    mult, length = 1, 0
    for _ in range(4):
        b = _read_exact(sock, 1)
        if b is None:
            return None
        length += (b[0] & 0x7F) * mult
        if not b[0] & 0x80:
            break
        mult *= 128
    else:
        raise ConnectionError("mqtt: malformed remaining length")
    if length > MQTT_MAX_PACKET:
        raise ConnectionError(
            f"mqtt: remaining length {length} exceeds protocol ceiling")
    payload = _read_exact(sock, length) if length else b""
    if length and payload is None:
        return None
    return ptype, flags, payload


def _send_packet(sock: socket.socket, ptype: int, payload: bytes,
                 flags: int = 0) -> None:
    # The NNL203 pragmas below are deliberate: callers hold their write
    # lock ACROSS these sends precisely so concurrent publishers cannot
    # interleave partial MQTT frames on the shared socket; the lock's
    # whole job is to serialize the blocking write.
    header = bytes([ptype << 4 | flags]) + _encode_len(len(payload))
    if not payload or not hasattr(sock, "sendmsg"):
        sock.sendall(header + payload)  # nnlint: disable=NNL203
        return
    # scatter-gather: one syscall, and a memoryview payload (a packed
    # tensor frame riding an MQTT body) is never copied to concatenate
    sent = sock.sendmsg([header, payload])
    if sent < len(header) + len(payload):  # rare partial write: stitch
        if sent < len(header):
            sock.sendall(header[sent:])  # nnlint: disable=NNL203
            sock.sendall(payload)  # nnlint: disable=NNL203
        else:
            sock.sendall(  # nnlint: disable=NNL203
                memoryview(payload)[sent - len(header):])


def _mqtt_str(s: bytes) -> bytes:
    return struct.pack(">H", len(s)) + s


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT wildcard match: ``+`` one level, ``#`` rest."""
    pp, tp = pattern.split("/"), topic.split("/")
    for i, p in enumerate(pp):
        if p == "#":
            return True
        if i >= len(tp):
            return False
        if p != "+" and p != tp[i]:
            return False
    return len(pp) == len(tp)


class MqttClient:
    """Blocking-connect, background-read MQTT 3.1.1 client (QoS0)."""

    def __init__(self, host: str, port: int, client_id: str = "",
                 keep_alive: int = 60, timeout: float = 10.0,
                 clean_session: bool = True):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self._write_lock = threading.Lock()
        self._on_message: Optional[Callable[[str, bytes], None]] = None
        self._pkt_id = 0
        self._suback = threading.Event()
        cid = (client_id or f"nns-{id(self) & 0xFFFF:x}-{int(time.time()) & 0xFFFF:x}")
        var = (_mqtt_str(b"MQTT") + bytes([4])        # protocol level 3.1.1
               + bytes([0x02 if clean_session else 0x00])
               + struct.pack(">H", keep_alive))
        _send_packet(self._sock, CONNECT, var + _mqtt_str(cid.encode()))
        pkt = _read_packet(self._sock)
        if pkt is None or pkt[0] != CONNACK or pkt[2][1] != 0:
            raise ConnectionError(f"mqtt connect refused: {pkt}")
        self._sock.settimeout(None)
        self._running = threading.Event()
        self._running.set()
        self._stop_evt = threading.Event()  # wakes the pinger immediately
        self._thread = threading.Thread(target=self._read_loop,
                                        name="mqtt-client", daemon=True)
        self._thread.start()
        self._keep_alive = keep_alive
        self._pinger = threading.Thread(target=self._ping_loop,
                                        name="mqtt-pinger", daemon=True)
        self._pinger.start()

    # -- api ----------------------------------------------------------------
    def publish(self, topic: str, payload, retain: bool = False) -> None:
        head = _mqtt_str(topic.encode())
        # join accepts buffer-protocol payloads (memoryview from
        # pack_tensors): ONE gather copy into the MQTT body, where
        # ``head + bytes(payload)`` paid a copy plus a concat copy
        body = b"".join((head, payload))
        with self._write_lock:
            _send_packet(self._sock, PUBLISH, body,
                         flags=0x01 if retain else 0x00)

    def subscribe(self, topic: str,
                  on_message: Callable[[str, bytes], None],
                  timeout: float = 10.0) -> None:
        self._on_message = on_message
        self._pkt_id += 1
        payload = struct.pack(">H", self._pkt_id) + _mqtt_str(topic.encode()) + b"\x00"
        self._suback.clear()
        with self._write_lock:
            _send_packet(self._sock, SUBSCRIBE, payload, flags=0x02)
        if not self._suback.wait(timeout):
            raise ConnectionError("mqtt: SUBACK timeout")

    def close(self) -> None:
        self._running.clear()
        self._stop_evt.set()
        try:
            with self._write_lock:
                _send_packet(self._sock, DISCONNECT, b"")
        except OSError:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        # the socket shutdown wakes the read loop; the stop event wakes
        # the pinger out of its keep-alive sleep — both join promptly
        for t in (self._thread, self._pinger):
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    # -- internals ----------------------------------------------------------
    def _ping_loop(self) -> None:
        interval = max(self._keep_alive - 5, 5)
        while not self._stop_evt.wait(interval):
            if not self._running.is_set():
                return
            try:
                with self._write_lock:
                    _send_packet(self._sock, PINGREQ, b"")
            except OSError:
                return

    def _read_loop(self) -> None:
        while self._running.is_set():
            try:
                pkt = _read_packet(self._sock)
            except (OSError, ConnectionError):
                pkt = None
            if pkt is None:
                return
            ptype, _, payload = pkt
            if ptype == PUBLISH:
                try:
                    (tlen,) = struct.unpack_from(">H", payload, 0)
                    topic = payload[2:2 + tlen].decode()
                except (struct.error, UnicodeDecodeError):
                    # a malformed frame must not kill the reader thread
                    # (and with it every later subscription)
                    logger.warning("mqtt: malformed PUBLISH frame dropped")
                    continue
                body = payload[2 + tlen:]
                cb = self._on_message
                if cb is not None:
                    try:
                        cb(topic, body)
                    except Exception as e:  # noqa: BLE001 - user callback
                        logger.warning("mqtt on_message error: %s", e)
            elif ptype == SUBACK:
                self._suback.set()
            # PINGRESP and others: ignored


class MiniBroker:
    """In-process MQTT 3.1.1 broker (QoS0 + retained messages).

    Plays the role of the external mosquitto broker in the reference's test
    setup; also usable as a deployment convenience for single-host pipelines.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()
        # (conn, pattern, per-conn write lock): ALL writes to a connection —
        # fan-outs from publisher threads and control replies from its own
        # serve thread — must hold that connection's lock, or concurrent
        # multi-send() payloads interleave and corrupt MQTT framing
        self._subs: List[Tuple[socket.socket, str, threading.Lock]] = []
        self._retained: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._running.set()
        self.refcount = 1
        # per-connection serve threads: stop() must CLOSE each conn (a
        # publish-only client's _serve thread is parked in a blocking
        # recv that only a shutdown wakes) before joining — the registry
        # carries the closer alongside the thread
        self._conn_reg = ThreadRegistry()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f"mqtt-broker:{self.port}",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name=f"mqtt-broker:{self.port}:conn",
                                 daemon=True)
            t.start()
            self._conn_reg.track(t, closer=_closer(conn))
            if not self._running.is_set():
                # stop() may have drained the registry between accept and
                # track — close the conn ourselves so the worker exits
                _closer(conn)()

    def _serve(self, conn: socket.socket) -> None:
        write_lock = threading.Lock()
        try:
            # deadline on the handshake only: a peer that connects and
            # never sends CONNECT must not park this thread forever
            # (socket.timeout is an OSError — caught below, clean exit)
            conn.settimeout(MQTT_CONNECT_DEADLINE_S)
            pkt = _read_packet(conn)
            if pkt is None or pkt[0] != CONNECT:
                conn.close()
                return
            with write_lock:
                _send_packet(conn, CONNACK, b"\x00\x00")
            conn.settimeout(None)
            while self._running.is_set():
                pkt = _read_packet(conn)
                if pkt is None:
                    break
                ptype, flags, payload = pkt
                if ptype == PUBLISH:
                    (tlen,) = struct.unpack_from(">H", payload, 0)
                    topic = payload[2:2 + tlen].decode()
                    body = payload[2 + tlen:]
                    if flags & 0x01:  # retain
                        with self._lock:
                            if body:
                                self._retained[topic] = body
                            else:
                                # MQTT 3.1.1 [3.3.1.3]: a zero-length
                                # retained payload DELETES the slot
                                self._retained.pop(topic, None)
                    self._fanout(topic, body)
                elif ptype == SUBSCRIBE:
                    (pkt_id,) = struct.unpack_from(">H", payload, 0)
                    (tlen,) = struct.unpack_from(">H", payload, 2)
                    pattern = payload[4:4 + tlen].decode()
                    with self._lock:
                        self._subs.append((conn, pattern, write_lock))
                        retained = [(t, b) for t, b in self._retained.items()
                                    if topic_matches(pattern, t)]
                    with write_lock:
                        _send_packet(conn, SUBACK,
                                     struct.pack(">H", pkt_id) + b"\x00")
                        for t, b in retained:
                            _send_packet(conn, PUBLISH,
                                         _mqtt_str(t.encode()) + b, flags=0x01)
                elif ptype == PINGREQ:
                    with write_lock:
                        _send_packet(conn, PINGRESP, b"")
                elif ptype == DISCONNECT:
                    break
        except (OSError, ConnectionError, struct.error, UnicodeDecodeError):
            pass
        finally:
            with self._lock:
                self._subs = [s for s in self._subs if s[0] is not conn]
            conn.close()

    def _fanout(self, topic: str, body: bytes) -> None:
        with self._lock:
            targets = [(c, lk) for c, p, lk in self._subs
                       if topic_matches(p, topic)]
        dead = []
        for c, lk in targets:
            try:
                with lk:
                    _send_packet(c, PUBLISH, _mqtt_str(topic.encode()) + body)
            except OSError:
                dead.append(c)
        if dead:
            with self._lock:
                self._subs = [s for s in self._subs if s[0] not in dead]

    def stop(self) -> None:
        self._running.clear()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        with self._lock:
            subs, self._subs = self._subs, []
        for c, _, _ in subs:
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=2.0)
        # closers wake _serve threads parked in recv, then they join
        self._conn_reg.drain(timeout_per=1.0)


# shared in-process brokers keyed by port (mqttsrc/sink with broker="embedded")
_embedded: Dict[int, MiniBroker] = {}
_embedded_lock = threading.Lock()


def get_embedded_broker(port: int = 0) -> MiniBroker:
    with _embedded_lock:
        if port != 0 and port in _embedded:
            b = _embedded[port]
            b.refcount += 1
            return b
        b = MiniBroker(port=port)
        _embedded[b.port] = b
        return b


def release_embedded_broker(b: MiniBroker) -> None:
    with _embedded_lock:
        b.refcount -= 1
        if b.refcount <= 0:
            _embedded.pop(b.port, None)
            b.stop()
