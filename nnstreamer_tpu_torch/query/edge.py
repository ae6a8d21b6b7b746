"""Topic pub/sub transport (L5).

The counterpart of nnstreamer_tpu's ``query/edge.py``.

Reference analog: ``gst/edge/`` edgesrc/edgesink over nnstreamer-edge
(topic-based pub/sub; MQTT-hybrid = broker for control + TCP for data,
SURVEY.md §5.8). Here the publisher embeds the broker: subscribers connect
over TCP, send the topic as a CAPABILITY query, receive the topic caps back,
then a DATA stream. This is the "hybrid" shape — no external broker process.
"""
from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, List, Optional, Tuple

from ..core import Buffer, Caps, parse_caps_string
from ..core.serialize import pack_tensors, unpack_tensors
from ..utils.log import logger
from ..utils.threads import ThreadRegistry
from .protocol import MsgType, recv_msg, send_msg
from .server import _shutdown_close


class PubSubBroker:
    """In-process topic broker with a TCP listener for remote subscribers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._topic_caps: Dict[str, Caps] = {}
        self._subs: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._running.set()
        self.refcount = 1
        # per-connection handshake threads: stop() shuts each conn down
        # (a handshake parked in recv only wakes on shutdown) then joins
        # — promoted subscriber sockets just get closed twice
        self._conn_reg = ThreadRegistry()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f"broker:{self.port}", daemon=True)
        self._thread.start()

    def set_topic_caps(self, topic: str, caps: Caps) -> None:
        with self._lock:
            self._topic_caps[topic] = caps

    def has_subscriber(self, topic: str) -> bool:
        with self._lock:
            return bool(self._subs.get(topic))

    def publish(self, topic: str, buf: Buffer) -> None:
        payload = pack_tensors(buf.as_numpy())
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for s in subs:
            try:
                send_msg(s, MsgType.DATA, payload)
            except OSError:
                self._drop(topic, s)

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handshake, args=(conn,),
                                 name=f"broker:{self.port}:handshake",
                                 daemon=True)
            t.start()
            self._conn_reg.track(
                t, closer=lambda c=conn: _shutdown_close(c))
            if not self._running.is_set():
                # stop() may have drained the registry between accept
                # and track — wake the worker ourselves
                _shutdown_close(conn)

    def _handshake(self, conn: socket.socket) -> None:
        try:
            # deadline on the handshake only: a peer that connects and
            # never sends its topic must not park this thread forever
            # (socket.timeout is an OSError — caught below, clean close)
            conn.settimeout(10.0)
            msg = recv_msg(conn)
            if msg is None or msg[0] is not MsgType.CAPABILITY:
                conn.close()
                return
            topic = msg[1].decode()
            with self._lock:
                caps = self._topic_caps.get(topic)
            if caps is None:
                send_msg(conn, MsgType.ERROR, f"unknown topic '{topic}'".encode())
                conn.close()
                return
            send_msg(conn, MsgType.CAPABILITY, str(caps).encode())
            conn.settimeout(None)  # publish sends are not deadline-bound
            with self._lock:
                self._subs.setdefault(topic, []).append(conn)
        except (OSError, ConnectionError, UnicodeDecodeError):
            # UnicodeDecodeError: garbage topic bytes must close the
            # connection, not kill the handshake thread with it open
            conn.close()

    def _drop(self, topic: str, s: socket.socket) -> None:
        with self._lock:
            if s in self._subs.get(topic, []):
                self._subs[topic].remove(s)
        try:
            s.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._running.clear()
        _shutdown_close(self._sock)
        with self._lock:
            all_subs = [s for lst in self._subs.values() for s in lst]
            self._subs.clear()
        for s in all_subs:
            try:
                send_msg(s, MsgType.EOS)
            except OSError:
                pass
            _shutdown_close(s)
        self._thread.join(timeout=2.0)
        # closers wake handshakes parked in recv, then they join
        self._conn_reg.drain(timeout_per=1.0)


class Subscriber:
    def __init__(self, host: str, port: int, topic: str, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        send_msg(self._sock, MsgType.CAPABILITY, topic.encode())
        self._sock.settimeout(timeout)
        msg = recv_msg(self._sock)
        if msg is None or msg[0] is not MsgType.CAPABILITY:
            detail = msg[1].decode() if msg else "connection closed"
            raise ConnectionError(f"edge subscribe failed: {detail}")
        self.caps = parse_caps_string(msg[1].decode())
        self._sock.settimeout(None)
        self._q: _queue.Queue = _queue.Queue()
        self._running = threading.Event()
        self._running.set()
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self) -> None:
        try:
            while self._running.is_set():
                msg = recv_msg(self._sock)
                if msg is None or msg[0] is MsgType.EOS:
                    break
                if msg[0] is MsgType.DATA:
                    self._q.put(unpack_tensors(msg[1]))
        except (OSError, ConnectionError) as e:
            logger.info("edge subscriber closed: %s", e)
        finally:
            self._q.put("eos")

    def next(self, timeout: float = 0.1):
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def close(self) -> None:
        from .server import _shutdown_close

        self._running.clear()
        _shutdown_close(self._sock)  # wakes the read loop
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)


# broker registry: edgesinks on the same (host,port) share one broker
_brokers: Dict[Tuple[str, int], PubSubBroker] = {}
_brokers_lock = threading.Lock()


def get_broker(host: str, port: int) -> PubSubBroker:
    with _brokers_lock:
        if port != 0:
            b = _brokers.get((host, port))
            if b is not None:
                b.refcount += 1
                return b
        b = PubSubBroker(host, port)
        _brokers[(b.host, b.port)] = b
        return b


def release_broker(broker: PubSubBroker) -> None:
    with _brokers_lock:
        broker.refcount -= 1
        if broker.refcount <= 0:
            _brokers.pop((broker.host, broker.port), None)
            broker.stop()


# ---------------------------------------------------------------------------
# connect-type=MQTT transport: data rides an external MQTT broker instead of
# the embedded TCP broker (reference nnstreamer-edge NNS_EDGE_CONNECT_TYPE_
# MQTT — caps as a retained message, frames as QoS0 publishes)
# ---------------------------------------------------------------------------


def _mqtt_data_topic(topic: str) -> str:
    return f"edge/{topic}"


class MqttPublisher:
    """``PubSubBroker``-shaped facade publishing via an external MQTT broker
    (edgesink connect-type=MQTT; dest-host/dest-port name the broker)."""

    def __init__(self, host: str, port: int):
        from .mqtt import MqttClient

        self._client = MqttClient(host, port)
        self.host, self.port = host, port

    def set_topic_caps(self, topic: str, caps: Caps) -> None:
        # retained: late subscribers still learn the stream caps
        self._client.publish(f"{_mqtt_data_topic(topic)}/caps",
                             str(caps).encode(), retain=True)

    def has_subscriber(self, topic: str) -> bool:
        # an external MQTT broker does not expose its subscriber list;
        # wait-connection degrades to publish-immediately
        return True

    def publish(self, topic: str, buf: Buffer) -> None:
        self._client.publish(_mqtt_data_topic(topic), pack_tensors(buf))

    def stop(self) -> None:
        self._client.close()


class MqttSubscriber:
    """``Subscriber``-shaped facade over MQTT: caps from the retained
    ``edge/<topic>/caps`` message, frames from ``edge/<topic>``."""

    def __init__(self, host: str, port: int, topic: str, timeout: float = 10.0):
        from .mqtt import MqttClient

        self._q: _queue.Queue = _queue.Queue()
        self._caps_evt = threading.Event()
        self.caps: Optional[Caps] = None
        self._client = MqttClient(host, port)
        data_topic = _mqtt_data_topic(topic)

        def on_message(t: str, body: bytes) -> None:
            if t == f"{data_topic}/caps":
                # str(buf, "utf-8") decodes straight from any buffer —
                # no intermediate bytes copy (cold path anyway, but the
                # idiom is free)
                self.caps = parse_caps_string(str(body, "utf-8"))
                self._caps_evt.set()
            elif t == data_topic:
                # per-frame hot path: unpack_tensors reads any contiguous
                # buffer directly; the old bytes(body) re-copied every
                # frame before the codec's own array copies (NNL405)
                self._q.put(unpack_tensors(body))

        self._client.subscribe(f"{data_topic}/caps", on_message,
                               timeout=timeout)
        self._client.subscribe(data_topic, on_message, timeout=timeout)
        if not self._caps_evt.wait(timeout):
            self._client.close()
            raise ConnectionError(
                f"edge mqtt subscribe: no retained caps on "
                f"'{data_topic}/caps' within {timeout}s (is the edgesink "
                "publishing on this broker?)")

    def next(self, timeout: float = 0.1):
        try:
            return self._q.get(timeout=timeout)
        except _queue.Empty:
            return None

    def close(self) -> None:
        self._client.close()
