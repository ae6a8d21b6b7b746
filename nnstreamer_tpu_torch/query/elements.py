"""Query/offload pipeline elements (L5) — the counterpart of nnstreamer_tpu's
``query/elements.py``, with its element names and properties.

Reference analogs (SURVEY.md §3.4):
  * ``tensor_query_client`` (tensor_query_client.c, 774 LoC) — sends each
    input frame to a remote server pipeline, emits the answer stream;
  * ``tensor_query_serversrc``/``serversink`` (server entry/exit pads with a
    shared per-id server handle and GstMetaQuery client routing);
  * ``edgesrc``/``edgesink`` (gst/edge/, topic pub/sub).

CLIENT:  ... ! tensor_query_client host=H port=P ! ...
SERVER:  tensor_query_serversrc port=P ! (sub-pipeline) ! tensor_query_serversink
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Optional

from ..core import Buffer, Caps, Event, EventType, clock_now, parse_caps_string
from ..registry.elements import register_element
from ..runtime.element import Element, ElementError, Prop, SinkElement, SourceElement, prop_bool
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger
from .client import DISCONNECTED, QueryClient, RemoteError
from .edge import PubSubBroker, get_broker, release_broker
from .server import (
    QueryServer,
    get_shared_server,
    lookup_shared_server,
    release_shared_server,
)

_TENSOR_CAPS = Caps.new("other/tensors")


def _connect_type(v) -> str:
    """reference connect-type values TCP|HYBRID|MQTT|AITT
    (nnstreamer-edge NNS_EDGE_CONNECT_TYPE_*). TCP = direct address;
    HYBRID = MQTT broker carries the topic→address advertisement, data
    still flows direct TCP (query/hybrid.py); MQTT = data itself rides the
    broker (edge.MqttPublisher/MqttSubscriber). AITT is a Samsung
    transport with no analog here — the enum value is accepted (the
    reference validates it at parse too) and the element fails at start,
    exactly like the reference without the AITT daemon."""
    s = str(v).upper()
    if s not in ("TCP", "HYBRID", "MQTT", "AITT"):
        raise ValueError(
            f"connect-type {v!r} not supported: TCP | HYBRID | MQTT | AITT")
    return s


def _require_transport(el, supported: tuple) -> None:
    """Fail at START (the reference validates the enum at parse and fails
    at connect) when the element does not implement the selected
    connect-type. MQTT data transport exists for edgesrc/edgesink only;
    AITT is a Samsung stack this framework does not ship."""
    ct = el.props["connect_type"]
    if ct in supported:
        return
    why = ("needs the Samsung AITT stack, which this framework does not "
           "ship" if ct == "AITT"
           else f"is not implemented for {el.ELEMENT_NAME}")
    raise ElementError(
        f"{el.describe()}: connect-type={ct} {why}; supported here: "
        f"{' | '.join(supported)}")


def _reject_aitt(el) -> None:  # edge elements: everything but AITT works
    _require_transport(el, ("TCP", "HYBRID", "MQTT"))

_CONNECT_TYPE_PROP = Prop(
    "TCP", _connect_type,
    "transport (reference connect-type): TCP = direct host/port; HYBRID = "
    "discover the data server via an MQTT broker (dest-host/dest-port + "
    "topic), then direct TCP data")


def _hybrid_topic(el) -> str:
    """The discovery topic; HYBRID is meaningless without one, so an empty
    topic fails at start instead of hanging a discovery timeout."""
    topic = el.props["topic"]
    if not topic:
        raise ElementError(
            f"{el.describe()}: connect-type=HYBRID requires topic=")
    return topic


def _hybrid_advertise(el, data_port: int) -> None:
    """Publish this element's data-server address for its topic. The
    advertised host is ``advertise-host`` when set (REQUIRED knowledge for
    wildcard binds: 0.0.0.0/:: is connectable only from the same machine)."""
    from .hybrid import advertise

    host = el.props["advertise_host"] or el.props["host"]
    if host in ("0.0.0.0", "::") and not el.props["advertise_host"]:
        logger.warning(
            "%s: advertising wildcard bind address %s — remote clients "
            "cannot connect to it; set advertise-host to this machine's "
            "reachable address", el.name, host)
    advertise(el.props["dest_host"], el.props["dest_port"],
              _hybrid_topic(el), host, data_port)


def _hybrid_withdraw(el) -> None:
    from .hybrid import withdraw

    try:  # best effort: the broker may already be gone at teardown
        withdraw(el.props["dest_host"], el.props["dest_port"],
                 _hybrid_topic(el))
    except (ConnectionError, OSError):
        pass




@register_element
class TensorQueryClient(Element):
    """Offload frames to a remote server pipeline; 1 sink (requests) + 1 src
    (responses). Responses are pushed from a puller thread (the reference's
    async pending-output queue)."""

    ELEMENT_NAME = "tensor_query_client"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    PROPERTIES = {
        "connect_type": _CONNECT_TYPE_PROP,
        "host": Prop("127.0.0.1", str,
                     "server host (reference dest-host); with "
                     "connect-type=HYBRID this is the MQTT broker host"),
        "port": Prop(0, int,
                     "server port (reference dest-port); with HYBRID the "
                     "MQTT broker port"),
        "topic": Prop("", str,
                      "HYBRID: discovery topic the server advertised under"),
        "timeout": Prop(10.0, float,
                        "connect/handshake timeout seconds (reference "
                        "QUERY_DEFAULT_TIMEOUT_SEC, tensor_query_common.h:28)"),
        "reconnect": Prop(True, prop_bool,
                          "on connection loss, retry with backoff instead of "
                          "ending the stream (reference CONNECTION_CLOSED "
                          "handling, tensor_query_client.c:421-480)"),
        "reconnect_window": Prop(30.0, float,
                                 "give up and end the stream after this many "
                                 "seconds without a successful reconnect"),
        "max_reconnect_delay": Prop(2.0, float,
                                    "backoff cap between reconnect attempts"),
        # the reference's four-property split (tensor_query_client.c):
        # host/port there are the CLIENT's bind address, dest-host/
        # dest-port the server. Here host/port already mean the server
        # (kept for back-compat); dest-* take precedence when set, so
        # reference lines work in ANY property order.
        "dest_host": Prop("", str,
                          "server host (reference dest-host; overrides "
                          "host when set)"),
        "dest_port": Prop(0, int,
                          "server port (reference dest-port; overrides "
                          "port when set)"),
        "wire": Prop("auto", str,
                     "data plane: auto = negotiate the NNSB binary wire "
                     "(falling back to json for old servers), json = "
                     "force legacy NNST frames (docs/transport.md)"),
        "shm": Prop(True, prop_bool,
                    "with wire=auto, also offer the same-host shared-"
                    "memory ring (only activates when the server proves "
                    "it shares this host's /dev/shm)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.client: Optional[QueryClient] = None
        self._puller: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._stopping = threading.Event()  # interrupts reconnect backoff
        self._in_caps: Optional[Caps] = None
        self._got_input_eos = False
        self._reconnect_error: Optional[str] = None

    def _server_addr(self):
        """dest-host/dest-port (reference spellings) override host/port
        when set — order-independent, matching the reference's split."""
        return (self.props["dest_host"] or self.props["host"],
                self.props["dest_port"] or self.props["port"])

    def _new_client(self) -> QueryClient:
        _require_transport(self, ("TCP", "HYBRID"))
        host, port = self._server_addr()
        if self.props["connect_type"] == "HYBRID":
            # re-discovered on EVERY connect (incl. reconnects): a server
            # that came back on a different address is found via the broker
            from .hybrid import discover

            host, port = discover(host, port, _hybrid_topic(self),
                                  self.props["timeout"],
                                  abort=self._stopping)
        return QueryClient(host, port, self.props["timeout"],
                           wire=self.props["wire"], shm=self.props["shm"])

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._in_caps = caps
        self.client = self._new_client()
        self._server_caps = self.client.connect(caps)
        self._running.set()
        self._puller = threading.Thread(target=self._pull_loop,
                                        name=f"{self.name}:pull", daemon=True)
        self._puller.start()

    def transform_caps(self, src_pad: Pad) -> Caps:
        return self._server_caps

    def chain(self, pad: Pad, buf: Buffer) -> None:
        try:
            self.client.send(buf)
        except (ConnectionError, OSError):
            # link is down; drop the frame and keep the stream alive while
            # the pull loop reconnects in the background (streaming QoS:
            # same frame-drop semantics as the reference under throttle)
            logger.warning("%s: frame dropped while disconnected", self.name)

    def handle_eos(self) -> None:
        self._got_input_eos = True
        if self.client is not None:
            self.client.send_eos()
        # EOS forwarded downstream when the response stream drains (pull loop)

    def _reconnect(self) -> bool:
        """Retry with exponential backoff until success, the reconnect
        window closes, the server comes back with different caps, or the
        element stops. Returns True on success; on failure the reason is
        in ``self._reconnect_error`` (None for a clean stop)."""
        self._reconnect_error: Optional[str] = None
        deadline = clock_now() + self.props["reconnect_window"]
        delay = 0.2
        while self._running.is_set() and clock_now() < deadline:
            try:
                client = self._new_client()
                new_caps = client.connect(self._in_caps)
                if not self._running.is_set():
                    # stop() raced the connect: don't leak the fresh
                    # socket + reader thread past pipeline shutdown
                    client.close()
                    return False
                if not new_caps.can_intersect(self._server_caps):
                    # downstream already negotiated the old caps; pushing an
                    # incompatible format would corrupt far from the cause.
                    # (Intersection, not string equality: the advertised
                    # string legitimately varies with server-side
                    # negotiation timing, e.g. num_tensors appearing.)
                    client.close()
                    self._reconnect_error = (
                        f"server at {self.props['host']}:{self.props['port']} "
                        f"came back with different caps ({new_caps} != "
                        f"{self._server_caps}); restart the pipeline")
                    return False
                old, self.client = self.client, client
                if old is not None:
                    old.close()  # release the dead link's fd + reader
                logger.info("%s: reconnected to %s:%s", self.name,
                            *self._server_addr())
                if self._got_input_eos:
                    # upstream EOS fired while the link was down; the dead
                    # socket swallowed it — re-send so the new server drains
                    self.client.send_eos()
                return True
            except (ConnectionError, OSError, TimeoutError) as e:
                logger.info("%s: reconnect failed (%s); retrying in %.1fs",
                            self.name, e, delay)
            time_left = deadline - clock_now()
            self._stopping.wait(min(delay, max(time_left, 0)))
            delay = min(delay * 2, self.props["max_reconnect_delay"])
        if self._running.is_set():
            self._reconnect_error = (
                f"connection to {self.props['host']}:{self.props['port']} "
                f"lost and not re-established within "
                f"{self.props['reconnect_window']}s")
        return False

    def _pull_loop(self) -> None:
        while self._running.is_set():
            try:
                buf = self.client.responses.get(timeout=0.1)
            except _queue.Empty:
                continue
            if buf is None:  # clean server EOS
                self.send_eos()
                return
            if isinstance(buf, RemoteError):
                # server shed this request (serving admission): same
                # frame-drop QoS semantics as a send while disconnected
                logger.warning("%s: request shed by server: %s",
                               self.name, buf)
                continue
            if buf is DISCONNECTED:
                if not self._running.is_set() or not self.props["reconnect"]:
                    self.send_eos()
                    return
                if self._reconnect():
                    continue
                if self._reconnect_error:  # None = clean stop, no error
                    self.post_error(self._reconnect_error)
                self.send_eos()
                return
            self.srcpad.push(buf)

    def stop(self) -> None:
        self._running.clear()
        self._stopping.set()
        if self.client is not None:
            self.client.close()
        if self._puller is not None and self._puller is not threading.current_thread():
            self._puller.join(timeout=2.0)
            self._puller = None
        if self.client is not None:
            # the puller may have installed a fresh client between the close
            # above and the join; close whatever is current (idempotent)
            self.client.close()

    def reset_flow(self) -> None:
        super().reset_flow()
        self._stopping.clear()
        self._got_input_eos = False


@register_element
class TensorQueryServerSrc(SourceElement):
    ELEMENT_NAME = "tensor_query_serversrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    PROPERTIES = {
        "connect_type": _CONNECT_TYPE_PROP,
        "host": Prop("127.0.0.1", str),
        "port": Prop(0, int, "listen port (0 = ephemeral; see bound_port)"),
        "id": Prop(0, int, "shared server id (pairs src and sink)"),
        "caps": Prop(None, str, "caps this server accepts/produces on its src"),
        "dest_host": Prop("127.0.0.1", str,
                          "HYBRID: MQTT broker host to advertise on"),
        "dest_port": Prop(1883, int, "HYBRID: MQTT broker port"),
        "topic": Prop("", str, "HYBRID: discovery topic to advertise under"),
        "advertise_host": Prop("", str,
                               "HYBRID: address to advertise instead of the "
                               "bind host (required when binding 0.0.0.0)"),
        # reference tensor_query_serversrc.c:111-127
        "timeout": Prop(10.0, float,
                        "seconds a new connection gets to complete the "
                        "caps handshake (reference timeout)"),
        "is_live": Prop(True, prop_bool,
                        "accepted for compat: this source is always a "
                        "live push source"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.server: Optional[QueryServer] = None

    @property
    def bound_port(self) -> int:
        return self.server.port if self.server else 0

    def start(self) -> None:
        _require_transport(self, ("TCP", "HYBRID"))
        self.server = get_shared_server(
            self.props["id"], self.props["host"], self.props["port"]
        )
        self.server.handshake_timeout = self.props["timeout"]
        if self.props["caps"]:
            accepted = parse_caps_string(self.props["caps"])
            # remote caps negotiation: reject clients whose stream cannot
            # intersect this server's declared input caps
            self.server.accept_caps = accepted.can_intersect
        if self.props["connect_type"] == "HYBRID":
            _hybrid_advertise(self, self.server.port)
        super().start()

    def get_src_caps(self) -> Caps:
        if not self.props["caps"]:
            raise ElementError(f"{self.describe()}: caps property required")
        return parse_caps_string(self.props["caps"])

    def create(self) -> Optional[Buffer]:
        while self.running:
            try:
                item = self.server.inbox.get(timeout=0.1)
            except _queue.Empty:
                continue
            if isinstance(item, tuple):  # ("eos", client_id): per-client end
                continue  # server keeps serving other clients
            return item
        return None

    def stop(self) -> None:
        super().stop()
        if self.server is not None:
            if self.props["connect_type"] == "HYBRID":
                _hybrid_withdraw(self)
            release_shared_server(self.props["id"])
            self.server = None


@register_element
class TensorQueryServerSink(SinkElement):
    ELEMENT_NAME = "tensor_query_serversink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    PROPERTIES = {
        "id": Prop(0, int, "shared server id (pairs src and sink)"),
        "connect_type": _CONNECT_TYPE_PROP,
        # reference tensor_query_serversink.c:82-95
        "timeout": Prop(10.0, float,
                        "handshake window applied to the shared server "
                        "(reference timeout)"),
        "limit": Prop(0, int,
                      "max pending request buffers stored server-side "
                      "before shedding (reference limit; 0 = unbounded)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.server: Optional[QueryServer] = None

    def start(self) -> None:
        _require_transport(self, ("TCP", "HYBRID"))

    def _server(self) -> QueryServer:
        # lazy lookup of the server the paired serversrc created — never
        # create here: the sink doesn't know the host/port (creating first
        # would pin an ephemeral port and void the src's port= property)
        if self.server is None:
            self.server = lookup_shared_server(self.props["id"])
            if self.props["limit"] > 0:
                self.server.inbox_limit = self.props["limit"]
            if self.props["timeout"] != type(self).PROPERTIES[
                    "timeout"].default:
                # explicit sink-side timeout wins over the src's default
                self.server.handshake_timeout = self.props["timeout"]
        return self.server

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._server().caps = caps  # advertised to clients in the handshake

    def render(self, buf: Buffer) -> None:
        client_id = buf.meta.get("client_id")
        if client_id is None:
            logger.warning("%s: answer without client_id meta dropped", self.name)
            return
        # pop the EXACT serve mark for this frame: a frame-dropping
        # element between serversrc and serversink would otherwise shift
        # every later answer's span/latency onto the wrong request via
        # the in-order counter fallback
        self._server().send(client_id, buf,
                            mark_idx=buf.meta.get("_qserve_idx"))

    def stop(self) -> None:
        super().stop()
        if self.server is not None:
            release_shared_server(self.props["id"])
            self.server = None


# ---------------------------------------------------------------------------
# edge pub/sub (reference gst/edge/: topic-based streams over nnstreamer-edge)
# ---------------------------------------------------------------------------


@register_element
class EdgeSink(SinkElement):
    """Publish the stream on a topic (reference ``edgesink``)."""

    ELEMENT_NAME = "edgesink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    PROPERTIES = {
        "connect_type": _CONNECT_TYPE_PROP,
        "host": Prop("127.0.0.1", str),
        "port": Prop(0, int, "broker listen port (0 = ephemeral)"),
        "topic": Prop("", str),
        "dest_host": Prop("127.0.0.1", str,
                          "HYBRID: MQTT broker host to advertise on"),
        "dest_port": Prop(1883, int, "HYBRID: MQTT broker port"),
        "advertise_host": Prop("", str,
                               "HYBRID: address to advertise instead of the "
                               "bind host (required when binding 0.0.0.0)"),
        # reference edge_sink.c: optionally hold the stream until a
        # subscriber is attached (frames published before any subscriber
        # connects are lost on a pub/sub transport)
        "wait_connection": Prop(False, prop_bool,
                                "block the first frames until a subscriber "
                                "connects (reference wait-connection)"),
        "connection_timeout": Prop(0.0, float,
                                   "seconds wait-connection waits before "
                                   "erroring (0 = forever; reference "
                                   "connection-timeout, ms there)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.broker: Optional[PubSubBroker] = None

    @property
    def bound_port(self) -> int:
        return self.broker.port if self.broker else 0

    def _wait_for_subscriber(self) -> None:
        import time as _time

        timeout = self.props["connection_timeout"]
        deadline = (_time.monotonic() + timeout) if timeout > 0 else None
        topic = self.props["topic"]
        while True:
            broker = self.broker
            if broker is None:
                return  # element stopped while waiting: drop, don't error
            if broker.has_subscriber(topic):
                return
            if deadline is not None and _time.monotonic() > deadline:
                raise ElementError(
                    f"{self.describe()}: no subscriber on '{topic}' within "
                    f"{timeout}s (wait-connection)")
            _time.sleep(0.01)

    def start(self) -> None:
        _reject_aitt(self)
        if self.props["connect_type"] == "MQTT":
            from .edge import MqttPublisher

            self.broker = MqttPublisher(self.props["dest_host"],
                                        self.props["dest_port"])
            return
        self.broker = get_broker(self.props["host"], self.props["port"])
        if self.props["connect_type"] == "HYBRID":
            _hybrid_advertise(self, self.broker.port)

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self.broker.set_topic_caps(self.props["topic"], caps)

    def render(self, buf: Buffer) -> None:
        if self.props["wait_connection"] and not getattr(
                self, "_subscriber_seen", False):
            self._wait_for_subscriber()
            self._subscriber_seen = True
        broker = self.broker
        if broker is None:
            return  # stopped mid-wait: frame dropped, not an error
        broker.publish(self.props["topic"], buf)

    def stop(self) -> None:
        if self.broker is not None:
            if self.props["connect_type"] == "MQTT":
                self.broker.stop()
            else:
                if self.props["connect_type"] == "HYBRID":
                    _hybrid_withdraw(self)
                release_broker(self.broker)
            self.broker = None


@register_element
class EdgeSrc(SourceElement):
    """Subscribe to a topic (reference ``edgesrc``)."""

    ELEMENT_NAME = "edgesrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    PROPERTIES = {
        "dest_host": Prop("127.0.0.1", str),
        "dest_port": Prop(0, int),
        "topic": Prop("", str),
        "timeout": Prop(10.0, float),
        "connect_type": _CONNECT_TYPE_PROP,
        # reference gstedgesrc.c: ``host``/``port`` are the src's own bind
        # address (0 = ephemeral); our subscriber dials out over one TCP
        # stream, so any requested local address is satisfiable — accepted
        # for compat
        "host": Prop("localhost", str,
                     "local bind host (accepted for compat — transport "
                     "dials outward)"),
        "port": Prop(0, int, "local bind port (0 = ephemeral; accepted "
                             "for compat — transport dials outward)"),
        # basesrc num-buffers semantics (the corpus caps every edgesrc
        # line with it): -1 = unlimited (GStreamer default), 0 = emit
        # nothing and EOS
        "num_buffers": Prop(-1, int,
                            "stop after N buffers (-1 = unlimited, "
                            "0 = emit none)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._sub = None
        self._emitted = 0

    def get_src_caps(self) -> Caps:
        from .edge import MqttSubscriber, Subscriber

        _reject_aitt(self)
        host, port = self.props["dest_host"], self.props["dest_port"]
        if self.props["connect_type"] == "MQTT":
            # frames ride the broker itself (no direct TCP data path)
            self._sub = MqttSubscriber(host, port, self.props["topic"],
                                       self.props["timeout"])
            return self._sub.caps
        if self.props["connect_type"] == "HYBRID":
            # dest-host/dest-port name the MQTT broker; the data broker's
            # address comes from its retained advertisement
            from .hybrid import discover

            host, port = discover(host, port, _hybrid_topic(self),
                                  self.props["timeout"])
        self._sub = Subscriber(host, port, self.props["topic"],
                               self.props["timeout"])
        return self._sub.caps

    def create(self) -> Optional[Buffer]:
        n_max = self.props["num_buffers"]
        if n_max >= 0 and self._emitted >= n_max:
            return None
        while self.running:
            buf = self._sub.next(timeout=0.1)
            if buf is not None:
                if buf == "eos":
                    return None
                self._emitted += 1
                return buf
        return None

    def stop(self) -> None:
        super().stop()
        if self._sub is not None:
            self._sub.close()
            self._sub = None
