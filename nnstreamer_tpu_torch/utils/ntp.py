"""SNTP client + epoch clock for cross-host timestamp alignment.

The counterpart of nnstreamer_tpu's ``utils/ntp.py``.

Reference analog: ``gst/mqtt/ntputil.c`` (``ntputil_get_epoch`` — one RFC
5905 mode-3 query, xmit-timestamp converted to Unix epoch µs) feeding the
``base_time_epoch`` field of the MQTT message header
(gst/mqtt/mqttcommon.h:49-61). Ours adds what that file's @todo asks for:
the queried offset is CACHED as a correction to the local wall clock
(``EpochClock``), so every subsequent ``epoch_us()`` is one clock read,
not a network round-trip per use.

Testable against a fake UDP responder exactly like the reference's gmock
NTP mock (tests/unittest_ntp_util_mock.cc → tests/test_mqtt_clock_sync.py).
"""
from __future__ import annotations

import socket
import struct
import time
from typing import Callable, List, Optional, Tuple

# seconds between the NTP epoch (1900) and the Unix epoch (1970)
NTP_DELTA = 2208988800
DEFAULT_SERVERS = "pool.ntp.org:123"


def sntp_epoch_us(host: str, port: int = 123, timeout: float = 2.0) -> int:
    """One SNTP (RFC 5905) query; returns the server's Unix epoch in µs.

    Raises OSError/ValueError on network failure or a bogus reply.
    """
    pkt = bytearray(48)
    pkt[0] = 0x1B  # li=0, vn=3, mode=3 (client)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.settimeout(timeout)
        sock.sendto(bytes(pkt), (host, port))
        data, _ = sock.recvfrom(256)
    if len(data) < 48:
        raise ValueError(f"short NTP reply ({len(data)} bytes)")
    sec, frac = struct.unpack("!II", data[40:48])  # transmit timestamp
    if sec <= NTP_DELTA:
        raise ValueError(f"NTP reply predates the Unix epoch (sec={sec})")
    return (sec - NTP_DELTA) * 1_000_000 + (frac * 1_000_000) // (1 << 32)


def parse_servers(spec: str) -> List[Tuple[str, int]]:
    """``"host:port,host2:port2"`` (reference ``ntp-srvs`` format) →
    [(host, port)]; port defaults to 123."""
    out = []
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port = item.partition(":")
        out.append((host, int(port) if port else 123))
    return out


class EpochClock:
    """Wall clock with an optional NTP-derived correction.

    ``sync()`` queries the configured servers in order (first answer wins,
    like the reference's hname loop) and stores ``offset_us`` = server
    epoch − local wall; ``epoch_us()`` then returns corrected epoch time
    from the local clock alone. Without servers (or before a successful
    sync) it reports the raw wall clock — the reference's non-ntp-sync
    default (``g_get_real_time``).
    """

    def __init__(self, servers: str = "", timeout: float = 2.0,
                 wall: Callable[[], float] = time.time):
        self._servers = parse_servers(servers)
        self._timeout = timeout
        self._wall = wall
        self.offset_us = 0
        self.synced = False

    def sync(self) -> bool:
        for host, port in self._servers:
            try:
                t0 = self._wall()
                server_us = sntp_epoch_us(host, port, self._timeout)
                t1 = self._wall()
                # timestamp the reply against the midpoint of the exchange
                # (classic NTP half-RTT correction)
                local_us = int((t0 + t1) / 2 * 1_000_000)
                self.offset_us = server_us - local_us
                self.synced = True
                return True
            except (OSError, ValueError):
                continue
        return False

    def epoch_us(self) -> int:
        return int(self._wall() * 1_000_000) + self.offset_us
