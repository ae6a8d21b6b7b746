"""mqttsrc / mqttsink: tensor streams over an MQTT broker (L5).

The counterpart of nnstreamer_tpu's ``elements/mqtt.py``.

Reference analog: ``gst/mqtt/`` (mqttsrc.c/mqttsink.c over Eclipse Paho,
message = 1024-byte header {num_mems, size_mems, base_time, caps string} +
payload, gst/mqtt/mqttcommon.h:49-61). Own design:

  * transport: our dependency-free MQTT 3.1.1 client (query/mqtt.py),
    wire-compatible with real brokers; ``broker=embedded`` starts an
    in-process MiniBroker (the loopback test story — the reference skips
    mqtt tests when no broker runs);
  * framing: the shared tensor wire format (core/serialize.py) — dtype/
    shape/pts/meta ride in the frame, no fixed-size header;
  * negotiation: caps string published RETAINED on ``<topic>/caps`` —
    late subscribers still negotiate (the reference re-sends caps in every
    message header instead);
  * clock sync: with ``ntp-sync=true`` both ends correct their wall clock
    via SNTP (utils/ntp.py, reference ntputil.c + ``ntp-sync``/``ntp-srvs``
    props); the publisher stamps every frame with ``base_time_epoch_us`` /
    ``sent_time_epoch_us`` (mqttcommon.h:49-61) and the subscriber
    re-anchors pts into its own running time exactly like the reference's
    ``_put_timestamp_on_gst_buf`` (mqttsrc.c:1380-1404): frames sent
    before the subscriber started lose their timestamp, negative results
    are dropped to None. Stamping/re-anchoring happens whether or not
    ntp-sync is on (reference parity: the non-NTP default stamps with the
    raw wall clock via g_get_real_time), so across hosts with unsynced
    clocks the pts error equals the clock skew — enable ntp-sync to
    bound it.
"""
from __future__ import annotations

import queue as _queue
import time
from typing import Optional

from ..core import Buffer, Caps, parse_caps_string
from ..core.serialize import pack_tensors, unpack_tensors
from ..registry.elements import register_element
from ..runtime.element import (ElementError, Prop, SinkElement,
                               SourceElement, prop_bool)
from ..runtime.pad import Pad, PadDirection, PadTemplate
from ..utils.log import logger
from ..utils.ntp import DEFAULT_SERVERS, EpochClock

_TENSOR_CAPS = Caps.new("other/tensors")

# wire meta keys for cross-host timestamp alignment (the reference's
# GstMQTTMessageHdr base_time_epoch / sent_time_epoch, in µs)
BASE_EPOCH_KEY = "mqtt_base_time_epoch_us"
SENT_EPOCH_KEY = "mqtt_sent_time_epoch_us"


# connection knobs both elements share (reference mqttsink.c/mqttsrc.c)
_MQTT_CLIENT_PROPS = {
    "cleansession": Prop(True, prop_bool,
                         "MQTT CONNECT clean-session flag (reference "
                         "cleansession)"),
    "keep_alive_interval": Prop(60, int,
                                "MQTT keep-alive seconds (PINGREQ cadence; "
                                "reference keep-alive-interval)"),
    "mqtt_qos": Prop(0, int,
                     "delivery QoS; this transport implements QoS0 — "
                     "higher values degrade to 0 with a logged warning"),
    "debug": Prop(False, prop_bool,
                  "log every MQTT publish/receive (reference debug)"),
}


def _mqtt_qos0(element) -> None:
    if element.props["mqtt_qos"] > 0:
        logger.warning("%s: mqtt-qos=%d requested but this transport is "
                       "QoS0; delivering at most once",
                       element.name, element.props["mqtt_qos"])


def _epoch_clock(element) -> EpochClock:
    """Build the element's epoch clock; ntp-sync failures post a warning
    and fall back to the raw wall clock (the reference logs and keeps
    g_get_real_time)."""
    clock = EpochClock(element.props["ntp_srvs"]
                       if element.props["ntp_sync"] else "")
    if element.props["ntp_sync"] and not clock.sync():
        logger.warning("%s: ntp-sync requested but no NTP server answered "
                       "(%s); using the raw wall clock",
                       element.name, element.props["ntp_srvs"])
    return clock


def _base_epoch_us(element, clock: EpochClock) -> int:
    """Epoch µs at the pipeline's running-time zero (reference: epoch(now)
    − (clock_time − base_time), mqttsrc.c:470-476)."""
    pipe = element.pipeline
    t0 = pipe.play_t0_mono if pipe is not None else None
    elapsed_us = 0 if t0 is None else int((time.monotonic() - t0) * 1e6)
    return clock.epoch_us() - elapsed_us


@register_element
class MqttSink(SinkElement):
    ELEMENT_NAME = "mqttsink"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    PROPERTIES = {
        "host": Prop("127.0.0.1", str, "broker host"),
        "port": Prop(1883, int, "broker port (embedded: 0 = ephemeral)"),
        "pub_topic": Prop("", str, "publish topic (reference pub-topic)"),
        "broker": Prop("external", str, "external | embedded (in-process)"),
        "client_id": Prop("", str),
        "ntp_sync": Prop(False, prop_bool,
                         "correct the wall clock via SNTP (reference ntp-sync)"),
        "ntp_srvs": Prop(DEFAULT_SERVERS, str,
                         "HOST:PORT,... NTP servers (reference ntp-srvs)"),
        **_MQTT_CLIENT_PROPS,
        "pub_wait_timeout": Prop(1.0, float,
                                 "accepted for compat: QoS0 publishes do "
                                 "not wait for broker acknowledgement"),
        "max_buffer_size": Prop(0, int,
                                "accepted for compat: frames are framed "
                                "exactly (core/serialize), no send buffer "
                                "to size"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client = None
        self._broker = None
        self._clock: Optional[EpochClock] = None
        self._base_epoch_us = 0

    @property
    def bound_port(self) -> int:
        """Embedded broker's actual port (for tests / mqttsrc wiring)."""
        return self._broker.port if self._broker else self.props["port"]

    def start(self) -> None:
        from ..query import mqtt

        if not self.props["pub_topic"]:
            raise ElementError(f"{self.describe()}: pub-topic required")
        host, port = self.props["host"], self.props["port"]
        if self.props["broker"] == "embedded":
            self._broker = mqtt.get_embedded_broker(port)
            host, port = self._broker.host, self._broker.port
        _mqtt_qos0(self)
        self._client = mqtt.MqttClient(
            host, port, client_id=self.props["client_id"],
            keep_alive=self.props["keep_alive_interval"],
            clean_session=self.props["cleansession"])
        self._clock = _epoch_clock(self)
        self._base_epoch_us = _base_epoch_us(self, self._clock)

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        self._client.publish(f"{self.props['pub_topic']}/caps",
                             str(caps).encode(), retain=True)

    def render(self, buf: Buffer) -> None:
        hdr = {BASE_EPOCH_KEY: self._base_epoch_us,
               SENT_EPOCH_KEY: self._clock.epoch_us()}
        if self.props["debug"]:
            logger.info("%s: publish pts=%s to '%s'", self.name, buf.pts,
                        self.props["pub_topic"])
        self._client.publish(self.props["pub_topic"],
                             pack_tensors(buf, extra_meta=hdr))

    def stop(self) -> None:
        from ..query import mqtt

        if self._client is not None:
            self._client.close()
            self._client = None
        if self._broker is not None:
            mqtt.release_embedded_broker(self._broker)
            self._broker = None


@register_element
class MqttSrc(SourceElement):
    ELEMENT_NAME = "mqttsrc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    PROPERTIES = {
        "host": Prop("127.0.0.1", str, "broker host"),
        "port": Prop(1883, int, "broker port"),
        "sub_topic": Prop("", str, "subscribe topic (reference sub-topic)"),
        "timeout": Prop(10.0, float, "caps-wait / connect timeout seconds"),
        "client_id": Prop("", str),
        "num_buffers": Prop(-1, int, "stop after N frames (-1 = endless)"),
        "ntp_sync": Prop(False, prop_bool,
                         "correct the wall clock via SNTP (reference ntp-sync)"),
        "ntp_srvs": Prop(DEFAULT_SERVERS, str,
                         "HOST:PORT,... NTP servers (reference ntp-srvs)"),
        **_MQTT_CLIENT_PROPS,
        "sub_timeout": Prop(0, int,
                            "subscribe/caps-wait timeout in MICROSECONDS "
                            "(reference sub-timeout; >0 overrides "
                            "timeout)"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client = None
        self._q: _queue.Queue = _queue.Queue()
        self._caps_q: _queue.Queue = _queue.Queue()
        self._count = 0
        self._clock: Optional[EpochClock] = None
        self._base_epoch_us = 0

    def get_src_caps(self) -> Caps:
        from ..query import mqtt

        topic = self.props["sub_topic"]
        if not topic:
            raise ElementError(f"{self.describe()}: sub-topic required")
        # sub-timeout (reference unit: microseconds) bounds the SUBSCRIBE
        # handshake + caps wait only; the TCP connect keeps the separate
        # 'timeout' property so a short caps wait can't break connecting
        # to a slow broker
        sub_timeout = self.props["timeout"]
        if self.props["sub_timeout"] > 0:
            sub_timeout = self.props["sub_timeout"] / 1e6
        _mqtt_qos0(self)
        self._client = mqtt.MqttClient(
            self.props["host"], self.props["port"],
            client_id=self.props["client_id"],
            timeout=self.props["timeout"],
            keep_alive=self.props["keep_alive_interval"],
            clean_session=self.props["cleansession"])
        caps_topic = f"{topic}/caps"

        def on_message(t: str, body: bytes) -> None:
            if self.props["debug"]:
                logger.info("%s: message on '%s' (%d bytes)",
                            self.name, t, len(body))
            if t == caps_topic:
                self._caps_q.put(body.decode())
            elif t == topic:
                try:
                    self._q.put(unpack_tensors(body))
                except ValueError as e:
                    logger.warning("%s: bad frame dropped: %s", self.name, e)

        # '<topic>/#' also matches '<topic>' itself (MQTT wildcard rules),
        # so one subscription covers the caps topic and the data stream
        self._client.subscribe(f"{topic}/#", on_message,
                               timeout=sub_timeout)
        try:
            caps_str = self._caps_q.get(timeout=sub_timeout)
        except _queue.Empty:
            raise ElementError(
                f"{self.describe()}: no retained caps on '{caps_topic}' "
                f"within {sub_timeout}s — is the publisher up?")
        return parse_caps_string(caps_str)

    def start(self) -> None:
        # fresh sync every (re)start, like the sink — a cached offset
        # would accumulate host clock drift across stop/play cycles
        self._clock = _epoch_clock(self)
        self._base_epoch_us = _base_epoch_us(self, self._clock)
        super().start()

    def _align_timestamp(self, buf: Buffer) -> Buffer:
        """Re-anchor the publisher's pts into THIS pipeline's running time
        (reference mqttsrc.c:1380-1404 _put_timestamp_on_gst_buf)."""
        base = buf.meta.pop(BASE_EPOCH_KEY, None)
        sent = buf.meta.pop(SENT_EPOCH_KEY, None)
        if base is None:
            return buf  # pre-clock-sync peer: leave pts as it arrived
        if sent is not None:
            buf.meta["mqtt_latency_us"] = self._clock.epoch_us() - sent
        if sent is not None and sent < self._base_epoch_us:
            buf.pts = None  # published before we started: not in our timeline
            return buf
        if buf.pts is not None:
            pts = buf.pts + (base - self._base_epoch_us) / 1e6
            buf.pts = pts if pts >= 0 else None
        return buf

    def create(self) -> Optional[Buffer]:
        limit = self.props["num_buffers"]
        if 0 <= limit <= self._count:
            return None
        while self.running:
            try:
                buf = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            self._count += 1
            return self._align_timestamp(buf)
        return None

    def reset_flow(self) -> None:
        super().reset_flow()
        self._count = 0

    def stop(self) -> None:
        super().stop()
        if self._client is not None:
            self._client.close()
            self._client = None
