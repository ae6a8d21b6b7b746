"""Tensor-query client core (L5) — the counterpart of nnstreamer_tpu's
``query/client.py``; it talks to either package's server.

Reference analog: the client side of nnstreamer-edge
(tensor_query_client.c:524-549 create/connect, :656-692 per-frame send,
:421-487 event callback receiving answers / connection-closed)."""
from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Optional

from ..core import Buffer, Caps, parse_caps_string
from ..core.caps import tensors_info_from_caps
from ..core.tensors import TensorFormat
from ..core.serialize import pack_tensors, unpack_tensors
from ..obs import context as obs_context
from ..utils.log import logger
from .. import transport
from ..transport import stats as wire_stats
from .protocol import MsgType, check_connect_fault, recv_msg, send_msg


class Disconnected:
    """Sentinel queued on connection loss (vs ``None`` = clean server EOS),
    so consumers can tell a dead link from end-of-stream — the reference
    distinguishes these via the CONNECTION_CLOSED event
    (tensor_query_client.c:421-480)."""


DISCONNECTED = Disconnected()


class RemoteError(RuntimeError):
    """A typed ERROR frame received AFTER the handshake — the server shed
    or failed this request (e.g. serving admission control on an
    attach_scheduler server). Rides the ``responses`` queue so a waiter
    blocked on an answer learns the request-level outcome promptly
    instead of timing out; the fabric retries these on another replica."""


def c2s_slot_bytes(caps: Caps) -> int:
    """Slot size of the ring a client sends ``caps``' frames through: sized
    for a static stream's whole frame (``transport.slot_bytes_for``);
    flexible or unfixed caps get the default slot."""
    try:
        info = tensors_info_from_caps(caps)
    except ValueError:
        return transport.shm.DEFAULT_SLOT_BYTES
    if (info.format is not TensorFormat.STATIC or not info.specs
            or not info.is_fixated):
        return transport.shm.DEFAULT_SLOT_BYTES
    return transport.slot_bytes_for(
        transport.frame_overhead(len(info.specs)) + info.nbytes)


class QueryClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 wire: str = "auto", shm: bool = True):
        self.host, self.port = host, port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self.responses: _queue.Queue = _queue.Queue()
        self.server_caps: Optional[Caps] = None
        self._caps_event = threading.Event()
        self._reader: Optional[threading.Thread] = None
        self._running = threading.Event()
        self.connected = False
        self._clean_eos = False
        # data-plane negotiation (transport/frame.py). ``wire``:
        #   "auto" — offer binary+json, use what the server selects
        #   "json" — legacy NNST frames only, no wire structure offered
        # ``shm`` additionally offers the same-host shared-memory ring;
        # it only activates when the server proves it shares our boot id.
        if wire not in ("auto", "json"):
            raise ValueError(f"wire must be 'auto' or 'json', not {wire!r}")
        self._wire_mode = wire
        self._shm_wanted = shm
        # slot size of our c2s ring, from the caps connect() offers
        self._shm_slot_bytes = transport.shm.DEFAULT_SLOT_BYTES
        self.wire_format = transport.FORMAT_JSON  # until negotiated
        self.shm_active = False
        self._ring = None          # our c2s ring (we create, server attaches)
        self._peer_rings = {}      # name -> attached s2c ring(s) of the server
        self._ring_lock = threading.Lock()
        self._stats_open = False

    def connect(self, caps: Caps) -> Caps:
        """TCP connect + caps handshake; returns the server's caps
        (remote caps negotiation, tensor_query_client.c:386-460)."""
        check_connect_fault(self.host, self.port)  # chaos partition gate
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=self.timeout)
        self._sock.settimeout(None)
        self._shm_slot_bytes = c2s_slot_bytes(caps)
        self._running.set()
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"qclient:{self.host}:{self.port}",
                                        daemon=True)
        self._reader.start()
        try:
            offer = str(caps)
            if self._wire_mode == "auto":
                # ride the wire offer on the existing CAPABILITY payload:
                # an old server's any-pair caps intersection still matches
                # the tensor structure and simply never echoes a selection
                # — the JSON fallback needs no second round trip
                offer = transport.offer_caps(
                    offer,
                    shm_host=(transport.same_host_token()
                              if self._shm_wanted else None))
            send_msg(self._sock, MsgType.CAPABILITY, offer.encode())
            if not self._caps_event.wait(self.timeout):
                raise TimeoutError("tensor-query caps handshake timed out")
            if self.server_caps is None:
                raise ConnectionError("tensor-query server rejected caps")
        except Exception:
            # a failed handshake must not leak the socket + reader thread
            # (retry loops create one client per attempt)
            self.close()
            raise
        self.connected = True
        wire_stats.note_connection(self.wire_format)
        self._stats_open = True
        return self.server_caps

    def _read_loop(self) -> None:
        try:
            while self._running.is_set():
                msg = recv_msg(self._sock)
                if msg is None:
                    break
                msg_type, payload = msg
                if msg_type is MsgType.CAPABILITY:
                    caps, wire = transport.split_wire_caps(
                        parse_caps_string(payload.decode()))
                    if wire is not None and self._wire_mode == "auto":
                        sel = wire.get("selected")
                        if str(sel) in (transport.FORMAT_BINARY,
                                        transport.FORMAT_JSON):
                            self.wire_format = str(sel)
                        if str(wire.get("shm", "")) == "1":
                            # server proved same host: create our c2s ring
                            # up front so send() never blocks on setup
                            with self._ring_lock:
                                if self._ring is None:
                                    self._ring = transport.create_ring(
                                        slot_bytes=self._shm_slot_bytes)
                            self.shm_active = True
                    self.server_caps = caps
                    self._caps_event.set()
                elif msg_type is MsgType.ERROR:
                    text = payload.decode(errors="replace")
                    if not self._caps_event.is_set():
                        # pre-handshake: caps rejection ends the connect
                        logger.error("tensor-query server error: %s", text)
                        self.server_caps = None
                        self._caps_event.set()
                    else:
                        # post-handshake: a request-level error (serving
                        # shed) — deliver it to the answer waiter
                        self.responses.put(RemoteError(text))
                elif msg_type is MsgType.DATA:
                    self.responses.put(self._decode_data(payload))
                elif msg_type is MsgType.EOS:
                    self._clean_eos = True
                    self.responses.put(None)
        except (ConnectionError, OSError) as e:
            # TornFrameError lands here too: a link cut mid-frame is a
            # typed disconnect, never a silent hang or a fake clean EOS
            logger.info("tensor-query connection closed: %s", e)
        except ValueError as e:
            # FrameError, NNST decode errors, UnicodeDecodeError (garbage
            # caps payload): a poisoned frame drops the link, typed —
            # never an unhandled exception leaving waiters to time out
            logger.error("tensor-query frame rejected, dropping link: %s", e)
        finally:
            self.connected = False
            if not self._caps_event.is_set():
                # reader died pre-handshake (garbage caps reply, torn
                # frame): fail connect() NOW with server_caps=None
                # instead of letting it run out the full timeout
                self._caps_event.set()
            # unblock any waiter: None = clean end, DISCONNECTED = link died
            self.responses.put(None if self._clean_eos else DISCONNECTED)

    def _decode_data(self, payload: bytes) -> Buffer:
        """Sniff-decode one inbound DATA payload: shm descriptor →
        binary frame → legacy NNST, by magic — a mixed fleet (old server,
        new client or vice versa) can never misparse a frame."""
        if transport.is_shm_descriptor(payload):
            name, slot, gen, nbytes = transport.unpack_descriptor(payload)
            with self._ring_lock:
                ring = self._peer_rings.get(name)
                if ring is None:
                    ring = transport.attach_ring(name)
                    self._peer_rings[name] = ring
            wire_stats.note_frame("shm", "rx", nbytes)
            return ring.read_frame(slot, gen, nbytes)
        if transport.is_binary_frame(payload):
            wire_stats.note_frame(transport.FORMAT_BINARY, "rx", len(payload))
            return transport.decode_frame(payload, copy=False)
        wire_stats.note_frame(transport.FORMAT_JSON, "rx", len(payload))
        return unpack_tensors(payload)

    def send(self, buf: Buffer) -> None:
        if self._sock is None:
            raise ConnectionError("tensor-query client not connected")
        if self.wire_format == transport.FORMAT_BINARY:
            try:
                # card tensors are pulled inside, once each
                parts = transport.encode_frame(buf)
            except transport.FrameError:
                # unencodable outlier (rank > 8): this one frame rides
                # the NNST fallback; the connection stays binary
                payload = pack_tensors(buf.as_numpy())
                wire_stats.note_frame(
                    transport.FORMAT_JSON, "tx", len(payload))
                send_msg(self._sock, MsgType.DATA, payload)
                return
            nbytes = transport.frame_nbytes(parts)
            if self.shm_active and self._ring is not None:
                desc = self._ring.write_frame(parts)
                if desc is not None:
                    # only the ~50-byte descriptor crosses the socket
                    wire_stats.note_frame("shm", "tx", nbytes)
                    send_msg(self._sock, MsgType.DATA, desc)
                    return
                # ring full / frame oversize: inline binary fallback
            wire_stats.note_frame(transport.FORMAT_BINARY, "tx", nbytes)
            send_msg(self._sock, MsgType.DATA, parts)
            return
        payload = pack_tensors(buf.as_numpy())
        wire_stats.note_frame(transport.FORMAT_JSON, "tx", len(payload))
        send_msg(self._sock, MsgType.DATA, payload)

    def request(self, buf: Buffer, timeout: float) -> Buffer:
        """Blocking call: send one frame, wait for ITS answer (the link is
        used exclusively by one in-flight request — the fabric's
        connection discipline — so FIFO matching is exact). Raises
        ``TimeoutError`` when no answer lands in ``timeout`` (the caller
        must then discard this client: a late answer would mis-match the
        next request), ``ConnectionError`` on link death/EOS, and
        :class:`RemoteError` when the server answered with a typed
        error.

        With request tracing on (obs/context.py) and no context already
        stamped by an upstream router, this is where the trace is MINTED:
        a root span whose context rides ``meta["trace"]`` to the server
        (the fabric stamps per-attempt contexts before calling here, so
        its requests keep their existing trace)."""
        span = None
        if obs_context.TRACING and "trace" not in buf.meta:
            span = obs_context.start_span(
                f"query.request:{self.host}:{self.port}", kind="query")
            buf.meta["trace"] = span.context().to_meta()
        status = "ok"
        try:
            self.send(buf)
            try:
                item = self.responses.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"no answer from {self.host}:{self.port} in "
                    f"{timeout:.2f}s")
            if item is None:
                raise ConnectionError("server ended the stream (EOS)")
            if item is DISCONNECTED:
                raise ConnectionError("connection lost awaiting the answer")
            if isinstance(item, RemoteError):
                raise item
            return item
        except BaseException as e:
            status = f"error:{type(e).__name__}"
            raise
        finally:
            if span is not None:
                span.end(status)

    def send_eos(self) -> None:
        if self._sock is not None:
            try:
                send_msg(self._sock, MsgType.EOS)
            except OSError:
                pass

    def close(self) -> None:
        self._running.clear()
        if self._sock is not None:
            from .server import _shutdown_close

            _shutdown_close(self._sock)
            self._sock = None
        if self._reader is not None:
            self._reader.join(timeout=2.0)
            self._reader = None
        with self._ring_lock:
            ring, self._ring = self._ring, None
            peers, self._peer_rings = dict(self._peer_rings), {}
        if ring is not None:
            # our c2s ring: reclaim slots the (possibly dead) server
            # still held in flight, then unlink — the generation bump
            # turns any descriptor it already sent into a typed stale
            ring.reclaim()
            transport.detach_ring(ring)
        for peer in peers.values():
            transport.detach_ring(peer)
        self.shm_active = False
        if self._stats_open:
            self._stats_open = False
            wire_stats.drop_connection(self.wire_format)
