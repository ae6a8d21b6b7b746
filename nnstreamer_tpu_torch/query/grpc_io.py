"""gRPC tensor streaming transport + tensor_src_grpc / tensor_sink_grpc (L5).

The counterpart of nnstreamer_tpu's ``query/grpc_io.py``: the same methods
and messages, so either package's element talks to the other's. ``grpc``
is imported only when an element opens its service or client; where it is
not installed that raises :class:`~..backends.base.FrameworkUnavailable`
naming grpc (a bus ERROR in a pipeline) — never another transport.

Reference analog: ``ext/nnstreamer/tensor_source/tensor_src_grpc.c`` +
``tensor_sink/tensor_sink_grpc.c`` with the shared ``NNStreamerRPC`` C++
class (ext/nnstreamer/extra/nnstreamer_grpc_common.h:32-83 — async
completion-queue server, client/server modes on both elements, protobuf or
flatbuf IDL). Redesign: grpcio with *generic* bytes methods — the IDL is
our own ``core/serialize`` tensor frame (already the wire format of the
query/edge/mqtt layers), so no codegen step and one serialization everywhere.

Service surface (bytes in/out, identity serializers). THREE IDLs:

* own wire (default client idl):
    /nnstreamer.Tensor/Send   client-streaming — remote pushes frames to us
    /nnstreamer.Tensor/Recv   server-streaming — remote pulls our stream
  Each stream message is 1 tag byte + payload: ``C`` caps string (always
  first), ``D`` serialized tensor frame (core/serialize — pts/meta/sparse
  ride along), ``E`` EOS.

* the reference's TensorService in BOTH its serializations
  (``idl=protobuf`` / ``idl=flatbuf`` on the client role; servers host
  all of them at once, so a reference peer connects unmodified):
    /nnstreamer.protobuf.TensorService/{Send,Recv}Tensors
    /nnstreamer.flatbuf.TensorService/{Send,Recv}Tensors
  Messages are the reference's ``Tensors`` in proto3 wire
  (ext/nnstreamer/include/nnstreamer.proto → core/wire_protobuf) or
  flatbuffers wire (include/nnstreamer.fbs → core/wire_flatbuf). These
  IDLs carry no caps/pts/meta channel: caps derive from each message's
  dimension/type fields and stream close is the EOS, matching the
  reference's semantics.

Like the reference, BOTH elements speak BOTH roles (``server=true/false``):
  sink(server=false) --Send-->  src(server=true)     (push topology)
  src(server=false)  --Recv-->  sink(server=true)    (pull topology)
"""
from __future__ import annotations

import queue as _queue
import threading
from concurrent import futures
from struct import error as struct_error
from typing import Optional, Tuple

import numpy as np

from ..core import (Buffer, Caps, TensorFormat, TensorsInfo,
                    caps_from_tensors_info, parse_caps_string,
                    tensors_info_from_caps)
from ..core import wire_flatbuf, wire_protobuf
from ..core.serialize import pack_tensors, unpack_tensors
from ..core.tensors import TensorSpec
from ..registry.elements import register_element
from ..runtime.element import ElementError, Prop, SinkElement, SourceElement, prop_bool
from ..runtime.pad import PadDirection, PadTemplate
from ..transport.frame import owning_message, owning_tagged
from ..utils.log import logger

_TENSOR_CAPS = Caps.new("other/tensors")
SEND_METHOD = "/nnstreamer.Tensor/Send"
RECV_METHOD = "/nnstreamer.Tensor/Recv"
PB_SEND_METHOD = "/nnstreamer.protobuf.TensorService/SendTensors"
PB_RECV_METHOD = "/nnstreamer.protobuf.TensorService/RecvTensors"
FB_SEND_METHOD = "/nnstreamer.flatbuf.TensorService/SendTensors"
FB_RECV_METHOD = "/nnstreamer.flatbuf.TensorService/RecvTensors"
# external IDLs: the reference's TensorService in either serialization
# (nnstreamer.proto / nnstreamer.fbs), message codec per idl
_EXT_IDL = {
    "protobuf": (PB_SEND_METHOD, PB_RECV_METHOD, wire_protobuf),
    "flatbuf": (FB_SEND_METHOD, FB_RECV_METHOD, wire_flatbuf),
}
IDLS = ("own",) + tuple(_EXT_IDL)
_IDENT = lambda b: bytes(b)  # noqa: E731 — identity (de)serializer


def _import_grpc(role: str):
    """``import grpc`` for a service or client, or a typed error naming
    it."""
    try:
        import grpc
    except ImportError as e:
        from ..backends.base import FrameworkUnavailable

        raise FrameworkUnavailable(
            f"{role} needs grpc (the grpcio package), which is not "
            f"installed here ({e}); tensor_query_client/serversrc or "
            "edgesink/edgesrc carry tensors over plain TCP") from e
    return grpc


def _tag(msg: bytes) -> tuple:
    if not msg:
        raise ValueError("empty grpc tensor message")
    return msg[:1], msg[1:]


def _check_idl(idl: str) -> str:
    if idl not in IDLS:
        raise ElementError(f"idl must be one of {IDLS}, got {idl!r}")
    return idl


def _buffer_to_ext(idl: str, buf: Buffer,
                   info: Optional[TensorsInfo] = None) -> bytes:
    """Buffer → reference ``Tensors`` bytes (per-idl codec); tensor names
    and stream format come from the negotiated ``info`` when available."""
    arrays = [np.ascontiguousarray(np.asarray(t))
              for t in buf.as_numpy().tensors]
    names = None
    fmt = TensorFormat.STATIC
    if info is not None:
        fmt = info.format
        if any(s.name for s in info.specs):
            names = [s.name for s in info.specs]
    return _EXT_IDL[idl][2].encode_tensors(arrays, names=names, fmt=fmt)


def _ext_to_buffer(idl: str, msg: bytes) -> Tuple[Buffer, Caps]:
    """Reference ``Tensors`` message → (Buffer, caps derived from the
    per-message dimension/type fields — these IDLs' only config channel)."""
    # grpc delivers owning bytes already; the codecs read any buffer —
    # wrapping in bytes() here paid a full-frame copy per message
    arrays, names, fmt, _rate = _EXT_IDL[idl][2].decode_tensors(msg)
    info = TensorsInfo(
        tuple(TensorSpec(a.shape, a.dtype, name) for a, name in
              zip(arrays, names)), fmt)
    return Buffer([a.copy() for a in arrays]), caps_from_tensors_info(info)


class GrpcTensorService:
    """Hosts Send (inbound frames → ``inbox``) and Recv (``outbox`` frames →
    subscribers). One service instance backs one element."""

    def __init__(self, host: str, port: int, max_queued: int = 64):
        grpc = _import_grpc("the grpc tensor service")

        self.inbox: _queue.Queue = _queue.Queue(max_queued)
        self.expected_caps: Optional[Caps] = None  # configured accept filter
        self.caps: Optional[Caps] = None           # learned from Send streams
        self._caps_lock = threading.Lock()
        self._out_caps: Optional[Caps] = None      # declared for Recv streams
        self._out_info: Optional[TensorsInfo] = None  # cached from out_caps
        self._out_caps_set = threading.Event()
        self._caps_seen = threading.Event()
        self._stopped = threading.Event()
        self._subs_lock = threading.Lock()
        self._subs: list = []                     # (queue, idl) per subscriber
        self._ext_encode_warned: set = set()  # idl names warned
        self._grpc = grpc

        def accept_caps(caps: Caps, context) -> None:
            """Shared Send-side caps gate (both IDLs): always validate
            against the CONFIGURED caps, never against what a previous
            client happened to declare; learn the first accepted caps."""
            with self._caps_lock:
                expected = self.expected_caps
                if expected is not None and not expected.can_intersect(caps):
                    reject = True
                else:
                    reject = False
                    if self.caps is None:
                        self.caps = caps
            if reject:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"caps {caps} rejected (server expects {expected})")
            self._caps_seen.set()

        def send_handler(request_iterator, context):
            got_caps = False
            for msg in request_iterator:
                tag, payload = _tag(msg)
                if tag == b"C":
                    accept_caps(parse_caps_string(payload.decode()), context)
                    got_caps = True
                elif tag == b"D":
                    if not got_caps:
                        context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                      "DATA before CAPABILITY")
                    if not self._inbox_put(unpack_tensors(payload), context):
                        return b"dropped"
                elif tag == b"E":
                    self._inbox_put(None, context)
            return b"ok"

        def _register_sub(idl: str) -> _queue.Queue:
            """Register the subscriber queue AT HANDLER ENTRY — frames/EOS
            published while the handler still waits for caps must queue,
            not vanish."""
            q: _queue.Queue = _queue.Queue(max_queued)
            with self._subs_lock:
                self._subs.append((q, idl))
            return q

        def _unregister_sub(q, idl: str) -> None:
            with self._subs_lock:
                if (q, idl) in self._subs:
                    self._subs.remove((q, idl))

        def _drain(q, context):
            """Yield queued payloads until EOS/stop. None = EOS marker."""
            while True:
                # bounded wait: the handler must exit when the service
                # stops or the client hangs up, else its executor thread
                # blocks process exit (concurrent.futures joins at atexit)
                try:
                    item = q.get(timeout=0.5)
                except _queue.Empty:
                    if self._stopped.is_set() or not context.is_active():
                        return
                    continue
                yield item  # None = EOS marker, else payload bytes
                if item is None:
                    return

        def recv_handler(request, context):
            q = _register_sub("own")
            try:
                # a subscriber may connect before the pipeline negotiated;
                # hold the caps message until set_caps ran
                if not self._out_caps_set.wait(timeout=10.0):
                    context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                  "server pipeline has no negotiated caps yet")
                yield b"C" + str(self._out_caps).encode()
                for item in _drain(q, context):
                    # owning_tagged gathers tag + memoryview frame in ONE
                    # copy (grpc needs an owning message anyway); the old
                    # ``b"D" + bytes(item)`` paid two
                    yield b"E" if item is None else owning_tagged(b"D", item)
            finally:
                _unregister_sub(q, "own")

        def ext_send_handler(idl):
            """Reference SendTensors (either IDL): stream of Tensors
            messages; caps come from each message's own config fields,
            stream close is EOS."""

            def handle(request_iterator, context):
                for msg in request_iterator:
                    try:
                        buf, caps = _ext_to_buffer(idl, msg)
                    except (ValueError, IndexError, KeyError,
                            struct_error) as e:
                        context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                      f"bad {idl} Tensors message: {e}")
                    accept_caps(caps, context)
                    if not self._inbox_put(buf, context):
                        return b""
                self._inbox_put(None, context)  # stream close = EOS
                return b""  # Empty

            return handle

        def ext_recv_handler(idl):
            def handle(request, context):
                q = _register_sub(idl)
                try:
                    # no caps preamble in these IDLs: config rides in every
                    # message, but frames only exist once the pipeline
                    # negotiated
                    if not self._out_caps_set.wait(timeout=10.0):
                        context.abort(
                            grpc.StatusCode.FAILED_PRECONDITION,
                            "server pipeline has no negotiated caps yet")
                    for item in _drain(q, context):
                        if item is None:
                            return  # EOS = end of stream (reference)
                        # grpc requires an owning immutable message;
                        # owning_message passes already-owning codec
                        # bytes through untouched and pays exactly ONE
                        # gather-copy for a borrowed pack_tensors view
                        # (the old unconditional bytes(item) re-copied
                        # the owning case too)
                        yield owning_message(item)
                finally:
                    _unregister_sub(q, idl)

            return handle

        handlers = [grpc.method_handlers_generic_handler(
            "nnstreamer.Tensor",
            {
                "Send": grpc.stream_unary_rpc_method_handler(
                    send_handler, request_deserializer=_IDENT,
                    response_serializer=_IDENT),
                "Recv": grpc.unary_stream_rpc_method_handler(
                    recv_handler, request_deserializer=_IDENT,
                    response_serializer=_IDENT),
            },
        )]
        # the reference's TensorService in BOTH serializations, hosted
        # SIMULTANEOUSLY: a peer built against nnstreamer.proto or
        # nnstreamer.fbs connects as-is
        for idl, (send_m, _recv_m, _codec) in _EXT_IDL.items():
            service = send_m.rsplit("/", 2)[1]
            handlers.append(grpc.method_handlers_generic_handler(
                service,
                {
                    "SendTensors": grpc.stream_unary_rpc_method_handler(
                        ext_send_handler(idl), request_deserializer=_IDENT,
                        response_serializer=_IDENT),
                    "RecvTensors": grpc.unary_stream_rpc_method_handler(
                        ext_recv_handler(idl), request_deserializer=_IDENT,
                        response_serializer=_IDENT),
                },
            ))
        self._executor = futures.ThreadPoolExecutor(max_workers=8)
        self._server = grpc.server(self._executor)
        self._server.add_generic_rpc_handlers(tuple(handlers))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise ElementError(f"grpc: cannot bind {host}:{port}")
        self._server.start()

    def _inbox_put(self, item, context) -> bool:
        """Bounded put that stays interruptible: a handler thread must never
        block forever in queue.put or it outlives server.stop() and wedges
        interpreter exit (same hazard as the recv_handler loop)."""
        while True:
            try:
                self.inbox.put(item, timeout=0.5)
                return True
            except _queue.Full:
                if self._stopped.is_set() or not context.is_active():
                    return False

    @property
    def out_caps(self) -> Optional[Caps]:
        return self._out_caps

    @out_caps.setter
    def out_caps(self, caps: Caps) -> None:
        self._out_caps = caps
        try:  # cached for pb encoding on the publish hot path
            self._out_info = tensors_info_from_caps(caps)
        except (ValueError, KeyError):
            self._out_info = None
        self._out_caps_set.set()

    def wait_caps(self, timeout: float) -> Optional[Caps]:
        self._caps_seen.wait(timeout)
        return self.caps

    def publish(self, buf: Optional[Buffer]) -> None:
        """Fan a frame (or None = EOS) out to every Recv subscriber,
        encoded per subscriber idl (lazily, once per idl in use).

        Live-stream semantics: a slow subscriber drops its oldest frame
        rather than backpressuring the pipeline's render thread (a blocking
        put here would also deadlock stop(), which publishes the EOS)."""
        with self._subs_lock:
            subs = list(self._subs)
        _skip = object()  # frame unencodable for this idl: skip those subs
        payloads: dict = {}
        for q, idl in subs:
            if idl not in payloads:
                if buf is None:
                    payloads[idl] = None
                elif idl in _EXT_IDL:
                    try:
                        payloads[idl] = _buffer_to_ext(idl, buf,
                                                       self._out_info)
                    except ValueError as e:
                        # e.g. bfloat16: not on the reference wire — a
                        # connected external peer must not kill the
                        # pipeline or starve the own-wire subscribers
                        if idl not in self._ext_encode_warned:
                            self._ext_encode_warned.add(idl)
                            logger.warning(
                                "grpc: frame not representable in the "
                                "%s IDL, skipping its subscribers: %s", idl, e)
                        payloads[idl] = _skip
                else:
                    payloads[idl] = pack_tensors(buf)
            if payloads[idl] is _skip:
                continue
            while True:
                try:
                    q.put_nowait(payloads[idl])
                    break
                except _queue.Full:
                    try:
                        q.get_nowait()  # drop oldest
                    except _queue.Empty:
                        pass

    def stop(self) -> None:
        self._stopped.set()
        self.publish(None)
        self._server.stop(grace=1.0).wait(timeout=5.0)
        self._executor.shutdown(wait=False)


class GrpcTensorClient:
    """Client side of both methods, in any IDL (``idl="protobuf"`` /
    ``"flatbuf"`` speak the reference's TensorService in either
    serialization, e.g. to a reference server)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 idl: str = "own"):
        grpc = _import_grpc("the grpc tensor client")

        self._grpc = grpc
        self._idl = _check_idl(idl)
        self._timeout = timeout
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        grpc.channel_ready_future(self._channel).result(timeout=timeout)
        self._send_q: Optional[_queue.Queue] = None
        self._send_info: Optional[TensorsInfo] = None
        self._send_future = None
        self._recv_call = None

    # -- push topology: we stream frames to a remote Send ------------------
    def start_send(self, caps: Caps) -> None:
        self._send_q = _queue.Queue(64)
        if self._idl in _EXT_IDL:
            method = _EXT_IDL[self._idl][0]  # no caps preamble in these IDLs
            try:  # names/format for the Tensors messages
                self._send_info = tensors_info_from_caps(caps)
            except (ValueError, KeyError):
                self._send_info = None
        else:
            method = SEND_METHOD
            self._send_q.put(b"C" + str(caps).encode())
        stub = self._channel.stream_unary(
            method, request_serializer=_IDENT, response_deserializer=_IDENT)

        def gen():
            while True:
                item = self._send_q.get()
                if item is None:
                    return
                yield item

        self._send_future = stub.future(gen())

    def send(self, buf: Buffer) -> None:
        if self._idl in _EXT_IDL:
            self._send_q.put(_buffer_to_ext(self._idl, buf, self._send_info))
        else:
            # one gather-copy into the owning grpc message (the old
            # ``b"D" + bytes(...)`` materialized the frame twice)
            self._send_q.put(owning_tagged(b"D", pack_tensors(buf)))

    def finish_send(self, timeout: float = 10.0) -> None:
        if self._idl not in _EXT_IDL:
            self._send_q.put(b"E")
        self._send_q.put(None)  # close the request stream (ext: EOS itself)
        if self._send_future is not None:
            self._send_future.result(timeout=timeout)

    # -- pull topology: we consume a remote Recv stream --------------------
    def recv_stream(self):
        """Yields (caps, iterator-of-Buffer-or-None)."""
        if self._idl in _EXT_IDL:
            stub = self._channel.unary_stream(
                _EXT_IDL[self._idl][1], request_serializer=_IDENT,
                response_deserializer=_IDENT)
            stream = stub(b"")  # Empty
            self._recv_call = stream
            # caps derive from the first Tensors message's config fields;
            # bound the wait (gRPC streams have no timed next, and an RPC
            # deadline would kill the whole long-lived stream)
            box: _queue.Queue = _queue.Queue(1)

            def _first():
                try:
                    box.put(("ok", next(stream)))
                except Exception as e:  # noqa: BLE001 — surfaced below
                    box.put(("err", e))

            first_thread = threading.Thread(target=_first, daemon=True)
            first_thread.start()
            try:
                kind, val = box.get(timeout=self._timeout)
            except _queue.Empty:
                stream.cancel()  # unblocks next(stream) in the helper
                first_thread.join(timeout=1.0)
                raise ConnectionError(
                    f"grpc ext Recv: no frame within {self._timeout}s "
                    "(remote negotiated but never published?)")
            first_thread.join(timeout=1.0)
            if kind == "err":
                raise ConnectionError(
                    f"grpc ext Recv stream ended before the first frame: {val}")
            first_buf, caps = _ext_to_buffer(self._idl, val)

            def ext_frames():
                yield first_buf
                for msg in stream:
                    buf, _caps = _ext_to_buffer(self._idl, msg)
                    yield buf
                yield None  # stream close = EOS

            return caps, ext_frames()
        stub = self._channel.unary_stream(
            RECV_METHOD, request_serializer=_IDENT, response_deserializer=_IDENT)
        stream = stub(b"")
        self._recv_call = stream  # cancellable from close()
        first = next(stream)
        tag, payload = _tag(first)
        if tag != b"C":
            raise ConnectionError("grpc Recv stream did not start with caps")
        caps = parse_caps_string(payload.decode())

        def frames():
            for msg in stream:
                tag, payload = _tag(msg)
                if tag == b"D":
                    yield unpack_tensors(payload)
                elif tag == b"E":
                    yield None
                    return

        return caps, frames()

    def close(self) -> None:
        if self._recv_call is not None:
            self._recv_call.cancel()
            self._recv_call = None
        if self._send_q is not None:
            self._send_q.put(None)  # unblock the request generator
        self._channel.close()


@register_element
class TensorSrcGrpc(SourceElement):
    """Receive a tensor stream over gRPC.

    server=true (default): host the service, remote sinks push via Send.
    server=false: connect out and pull a remote tensor_sink_grpc's Recv.
    """

    ELEMENT_NAME = "tensor_src_grpc"
    SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, _TENSOR_CAPS),)
    PROPERTIES = {
        "server": Prop(True, prop_bool, "host the service vs connect out"),
        "host": Prop("127.0.0.1", str),
        "port": Prop(0, int, "listen/connect port (0 server = ephemeral)"),
        "caps": Prop(None, str, "expected caps (optional in server mode)"),
        "timeout": Prop(10.0, float, "caps handshake timeout"),
        "idl": Prop("own", str,
                    "client-role wire: own | protobuf | flatbuf (the "
                    "reference TensorService in either serialization); "
                    "servers host all three at once"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        _check_idl(self.props["idl"])  # typos surface at construction
        self.service: Optional[GrpcTensorService] = None
        self._client: Optional[GrpcTensorClient] = None
        self._frames = None

    @property
    def bound_port(self) -> int:
        return self.service.port if self.service else 0

    def get_src_caps(self) -> Caps:
        if self.props["server"]:
            self.service = GrpcTensorService(self.props["host"], self.props["port"])
            if self.props["caps"]:
                caps = parse_caps_string(self.props["caps"])
                self.service.expected_caps = caps  # Send streams must intersect
                return caps
            got = self.service.wait_caps(self.props["timeout"])
            if got is None:
                raise ElementError(
                    f"{self.describe()}: no client sent caps within timeout "
                    "(set the caps property to negotiate before connect)")
            return got
        self._client = GrpcTensorClient(self.props["host"], self.props["port"],
                                        self.props["timeout"],
                                        idl=self.props["idl"])
        caps, self._frames = self._client.recv_stream()
        return caps

    def create(self) -> Optional[Buffer]:
        service = self.service  # stop() may null the attribute concurrently
        if self.props["server"]:
            while self.running and service is not None:
                try:
                    return service.inbox.get(timeout=0.1)  # None = EOS
                except _queue.Empty:
                    continue
            return None
        try:
            return next(self._frames)
        except StopIteration:
            return None
        except Exception as e:  # noqa: BLE001 — stream cancelled / transport err
            logger.warning("%s: recv stream ended: %s", self.describe(), e)
            return None

    def stop(self) -> None:
        # tear the transport down BEFORE joining the task thread: a create()
        # blocked in next(frames) only wakes when the call is cancelled
        self._running.clear()
        if self.service is not None:
            self.service.stop()
        if self._client is not None:
            self._client.close()
            self._client = None
        super().stop()
        self.service = None


@register_element
class TensorSinkGrpc(SinkElement):
    """Send the pipeline's tensor stream over gRPC.

    server=false (default): stream to a remote tensor_src_grpc via Send.
    server=true: host the service; remote srcs subscribe via Recv.
    """

    ELEMENT_NAME = "tensor_sink_grpc"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, _TENSOR_CAPS),)
    PROPERTIES = {
        "server": Prop(False, prop_bool, "host the service vs connect out"),
        "host": Prop("127.0.0.1", str),
        "port": Prop(0, int, "connect/listen port (0 server = ephemeral)"),
        "timeout": Prop(10.0, float, "connect timeout"),
        "idl": Prop("own", str,
                    "client-role wire: own | protobuf | flatbuf (the "
                    "reference TensorService in either serialization); "
                    "servers host all three at once"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        _check_idl(self.props["idl"])  # typos surface at construction
        self.service: Optional[GrpcTensorService] = None
        self._client: Optional[GrpcTensorClient] = None

    @property
    def bound_port(self) -> int:
        return self.service.port if self.service else 0

    def set_caps(self, pad, caps: Caps) -> None:
        if self.props["server"]:
            if self.service is None:
                self.service = GrpcTensorService(self.props["host"],
                                                 self.props["port"])
            self.service.out_caps = caps
        else:
            if self._client is not None:  # renegotiation: end the old stream
                try:
                    self._client.finish_send(timeout=2.0)
                except Exception:  # noqa: BLE001 — best-effort drain
                    pass
                self._client.close()
            self._client = GrpcTensorClient(self.props["host"], self.props["port"],
                                            self.props["timeout"],
                                            idl=self.props["idl"])
            self._client.start_send(caps)

    def render(self, buf: Buffer) -> None:
        if self.props["server"]:
            self.service.publish(buf)
        else:
            self._client.send(buf)

    def handle_eos(self) -> None:
        if self.props["server"]:
            if self.service is not None:
                self.service.publish(None)
        elif self._client is not None:
            self._client.finish_send()
        super().handle_eos()

    def stop(self) -> None:
        super().stop()
        if self.service is not None:
            self.service.stop()
            self.service = None
        if self._client is not None:
            self._client.close()
            self._client = None
