"""MQTT-hybrid discovery (L5).

The counterpart of nnstreamer_tpu's ``query/hybrid.py``.

Reference analog: nnstreamer-edge's MQTT-hybrid connection
(``connect-type=HYBRID`` on the query/edge elements; CHANGES:11 "mqtt
control + tcp data"): an MQTT broker carries only the topic →
``host:port`` ADVERTISEMENT of a data server; tensor data then flows
over a direct TCP link. The broker is tiny control-plane traffic, data
never rides it.

Server side: ``advertise()`` publishes the address RETAINED, so late
subscribers still discover it; ``withdraw()`` clears the retained slot.
Client side: ``discover()`` subscribes and returns the advertised
address (re-invoked on reconnect, so a server that comes back on a new
port is found — elastic recovery the reference's fixed dest-host lacks).
"""
from __future__ import annotations

import queue as _queue
from typing import Tuple

ADDR_TOPIC = "nns/edge/{topic}/addr"


def advertise(broker_host: str, broker_port: int, topic: str,
              host: str, port: int) -> None:
    from .mqtt import MqttClient

    c = MqttClient(broker_host, broker_port)
    try:
        c.publish(ADDR_TOPIC.format(topic=topic),
                  f"{host}:{port}".encode(), retain=True)
    finally:
        c.close()


def withdraw(broker_host: str, broker_port: int, topic: str) -> None:
    """Clear the retained advertisement (empty retained payload)."""
    from .mqtt import MqttClient

    c = MqttClient(broker_host, broker_port)
    try:
        c.publish(ADDR_TOPIC.format(topic=topic), b"", retain=True)
    finally:
        c.close()


def discover(broker_host: str, broker_port: int, topic: str,
             timeout: float = 10.0, abort=None) -> Tuple[str, int]:
    """Resolve a topic's data-server address from the broker. Waits up to
    ``timeout`` TOTAL for an advertisement (covers the
    server-starts-after-client race: the live publish arrives on the same
    subscription; withdrawn/empty payloads don't restart the clock).
    ``abort`` (a ``threading.Event``) cancels the wait early — a stopping
    pipeline must not sit out the full discovery window."""
    import time

    from .mqtt import MqttClient

    deadline = time.monotonic() + timeout
    q: _queue.Queue = _queue.Queue()
    c = MqttClient(broker_host, broker_port, timeout=timeout)
    try:
        c.subscribe(ADDR_TOPIC.format(topic=topic),
                    lambda t, body: q.put(body), timeout=timeout)
        while True:
            if abort is not None and abort.is_set():
                raise ConnectionError("discovery aborted (element stopping)")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _queue.Empty
            try:
                body = q.get(timeout=min(remaining, 0.2) if abort is not None
                             else remaining)
            except _queue.Empty:
                continue
            if body:  # empty = withdrawn; keep waiting within the deadline
                break
    except _queue.Empty:
        raise ConnectionError(
            f"no data server advertised for topic '{topic}' on "
            f"{broker_host}:{broker_port} within {timeout}s")
    finally:
        c.close()
    # rpartition: IPv6 literals contain ':' in the host part
    host, _, port = body.decode().rpartition(":")
    if not host or not port.isdigit():
        raise ConnectionError(
            f"malformed advertisement for topic '{topic}': {body!r}")
    return host, int(port)
