"""Tensor-query server core (L5) — the counterpart of nnstreamer_tpu's
``query/server.py``; it serves either package's clients.

Reference analog: the server side of nnstreamer-edge as used by
``tensor_query_serversrc``/``serversink`` — a shared per-server-id handle
(tensor_query_server.c:76-117) accepting clients, performing the CAPABILITY
handshake, tagging inbound frames with ``client_id`` and routing answers back
to the right client (tensor_query_serversrc.c:299-315, GstMetaQuery).
"""
from __future__ import annotations

import collections
import queue as _queue
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core import Buffer, Caps, parse_caps_string
from ..core.serialize import pack_tensors, unpack_tensors
from ..obs import context as obs_context
from ..obs import profile as obs_profile
from ..utils.log import logger
from ..utils.threads import ThreadRegistry
from .. import transport
from ..transport import stats as wire_stats
from .protocol import MsgType, recv_msg, send_msg

#: the request series a served query records under (obs/profile.py) —
#: one deployment-shaped name, NOT per-port, so every replica of one
#: fleet exports the SAME series and a fleet merge pools them
SERVE_SERIES = "serving:query"


class _ServeTrack:
    """Per-client serve attribution (see ``QueryServer._inflight``).

    ``recv``/``sent`` count EVERY data frame / answer on the
    connection (two int adds — kept on even when observability is
    off), so each pending mark carries the frame INDEX its answer will
    have. Popping matches indices instead of trusting a bare FIFO:
    frames received while tracing/profiling was off, silently-shed
    frames, and marks dropped by the deque bound can therefore never
    shift a later answer's span/latency onto the wrong request — an
    unmatched answer simply goes unattributed."""

    __slots__ = ("marks", "recv", "sent")

    def __init__(self):
        # guarded-by: QueryServer._lock (reader appends, senders pop)
        self.marks: collections.deque = collections.deque(maxlen=256)
        self.recv = 0   # written by the one client reader thread
        self.sent = 0   # guarded-by: QueryServer._lock


def _shutdown_close(sock: socket.socket) -> None:
    """shutdown() before close(): close() alone does NOT send FIN while
    another thread is blocked in recv() on the same fd — the peer would
    never see EOF and hang."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class QueryServer:
    """Accepts tensor-query clients; inbound frames land in ``inbox`` with
    client_id meta; ``send(client_id, buf)`` answers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 caps: Optional[Caps] = None,
                 accept_caps: Optional[Callable[[Caps], bool]] = None,
                 handshake_timeout: float = 10.0):
        # reference serversrc/-sink ``timeout``: window a new connection
        # gets to complete the capability handshake; ``limit`` (serversink)
        # bounds pending stored buffers — both adjustable on the shared
        # server after creation
        self.handshake_timeout = handshake_timeout
        self.inbox_limit = 0  # 0 = unbounded
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self.caps = caps
        self.accept_caps = accept_caps
        self.inbox: _queue.Queue = _queue.Queue()
        self._clients: Dict[int, socket.socket] = {}
        self._client_caps: Dict[int, Caps] = {}
        # negotiated data plane per client (transport/frame.py): wire
        # format selected at handshake, whether the same-host shm ring is
        # on, our lazily-created s2c ring, and the client's c2s rings we
        # attached (by segment name). All guarded-by: _lock.
        self._client_wire: Dict[int, str] = {}
        self._client_shm: Dict[int, bool] = {}
        self._client_ring_out: Dict[int, transport.ShmRing] = {}
        self._client_rings_in: Dict[int, Dict[str, transport.ShmRing]] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._accepting = False
        self._serving = False
        # in-flight serve attribution per client, index-matched
        # (answers route back in request order on one connection; see
        # :class:`_ServeTrack` for why indices, not a bare FIFO). Each
        # mark is (frame_idx, recv_t0, span). The span half is the
        # cross-PROCESS trace story — a trace context arriving in the
        # frame meta (fabric attempt / remote client root) mints a
        # ``query.serve`` child span HERE, so this process's span
        # export stitches into the caller's trace; the t0 half records the serve latency as the
        # ``serving:query`` request series every replica of a fleet
        # shares. guarded-by: _lock (table; see _ServeTrack for fields)
        self._inflight: Dict[int, _ServeTrack] = {}
        self._client_threads = ThreadRegistry()
        # accept/serve threads ride a registry (like client-connection
        # workers), so stop() joins them uniformly and SURFACES any
        # straggler instead of silently abandoning it
        self._core_threads = ThreadRegistry()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "QueryServer":
        if self._accepting:
            return self
        self._accepting = True
        self._running.set()
        t = threading.Thread(
            target=self._accept_loop, name=f"qserver:{self.port}", daemon=True
        )
        t.start()
        self._core_threads.track(
            t, closer=lambda: _shutdown_close(self._sock))
        return self

    def stop(self) -> List[threading.Thread]:
        """Stop accepting, wake and join every worker. Returns the
        STRAGGLERS — threads that outlived their join timeout — after
        logging them, so callers (and the autouse thread-leak fixture)
        see a stuck accept/serve/client worker instead of a silent
        daemon leak."""
        self._running.clear()
        _shutdown_close(self._sock)
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            _shutdown_close(c)
        # client sockets just closed above: the loops exit promptly
        stragglers = self._client_threads.drain(timeout_per=1.0)
        stragglers += self._core_threads.drain(timeout_per=2.0)
        self._accepting = False
        self._serving = False
        for t in stragglers:
            logger.warning(
                "query server %d: thread %s still alive after stop() "
                "join timeout — it will leak until it unblocks",
                self.port, t.name)
        return stragglers

    # -- serving-scheduler bridge -------------------------------------------
    def attach_scheduler(self, scheduler, priority: int = 0,
                         deadline_s: Optional[float] = None) -> None:
        """Serve this server's inbox through a continuous-batching
        :class:`~nnstreamer_tpu_torch.serving.Scheduler` — N TCP clients each
        sending batch-1 frames transparently share one coalesced device
        batch (the serving-layer replacement for a serversrc→filter→
        serversink sub-pipeline, which executes each client's frame as
        its own invoke). Answers route back per ``client_id``; shed
        requests answer with a typed ERROR message instead of silence.

        Standalone-server mode only: the bridge consumes ``inbox``, so do
        not combine with a ``tensor_query_serversrc`` on the same id.
        """
        if self._serving:
            raise RuntimeError("a scheduler is already attached")
        self._serving = True
        self.start()

        def _error_reply(client_id: int, err: BaseException,
                         idx: Optional[int] = None) -> None:
            with self._lock:
                conn = self._clients.get(client_id)
                # a typed ERROR is this request's answer: pop its mark
                # too (exact by frame index — sheds overtake earlier
                # in-flight frames, see _pop_mark_locked)
                mark, stale = self._pop_mark_locked(client_id, idx)
            for sp in stale:
                sp.end("error:unanswered")
            if mark is not None:
                _idx, t0, span = mark
                if span is not None:
                    span.end(f"error:{type(err).__name__}")
                if obs_profile.ACTIVE:
                    obs_profile.record_request(
                        SERVE_SERIES, time.monotonic() - t0, ok=False)
            if conn is not None:
                try:
                    send_msg(conn, MsgType.ERROR,
                             f"{type(err).__name__}: {err}".encode())
                except OSError:
                    pass

        def _answer(client_id: int, req,
                    idx: Optional[int] = None) -> None:
            if req.error is not None:
                _error_reply(client_id, req.error, idx)
                return
            out = Buffer(list(req.result()))
            out.meta["serving"] = dict(req.metrics)
            self.send(client_id, out, mark_idx=idx)

        def _serve_loop() -> None:
            from ..serving import AdmissionError, ServingError

            while self._running.is_set():
                try:
                    item = self.inbox.get(timeout=0.1)
                except _queue.Empty:
                    continue
                if isinstance(item, tuple):  # ("eos", client_id)
                    continue
                client_id = item.meta.get("client_id")
                # fabric deadline propagation: a frame that arrived with
                # a remaining budget (a fabric stamps it per attempt)
                # must not occupy a batch slot it cannot finish
                # in — the TIGHTER of the frame's budget and the static
                # attach-time deadline applies
                eff_deadline = deadline_s
                fabric_meta = item.meta.get("fabric")
                if isinstance(fabric_meta, dict):
                    try:  # meta is client-supplied wire data: a bad
                        # value must not kill the one serve thread
                        budget = float(fabric_meta["deadline_s"])
                    except (KeyError, TypeError, ValueError):
                        budget = None
                    if budget is not None:
                        eff_deadline = (budget if deadline_s is None
                                        else min(deadline_s, budget))
                # trace propagation: the client's (or the fabric
                # attempt's) span context arrived in the frame meta —
                # hand it to the scheduler so the batch span links to it
                trace_ctx = None
                if obs_context.TRACING:
                    trace_ctx = obs_context.TraceContext.from_meta(
                        item.meta.get("trace"))
                serve_idx = item.meta.get("_qserve_idx")
                try:
                    scheduler.submit(
                        tuple(item.tensors), priority=priority,
                        deadline_s=eff_deadline, trace=trace_ctx,
                        on_done=lambda req, cid=client_id, i=serve_idx:
                            _answer(cid, req, i))
                except AdmissionError:
                    pass  # on_done already delivered the typed ERROR
                except ServingError as err:
                    # e.g. SchedulerClosedError: submit raises before a
                    # Request exists so no on_done fires — answer here and
                    # keep serving, so every later frame also gets the
                    # typed ERROR instead of a dead thread's silence
                    _error_reply(client_id, err, serve_idx)

        t = threading.Thread(
            target=_serve_loop, name=f"qserver:{self.port}:serve",
            daemon=True)
        t.start()
        self._core_threads.track(t)

    # -- accept/read --------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            with self._lock:
                client_id = self._next_id
                self._next_id += 1
                self._clients[client_id] = conn
                self._inflight[client_id] = _ServeTrack()
            t = threading.Thread(
                target=self._client_loop, args=(client_id, conn),
                name=f"qserver:{self.port}:c{client_id}", daemon=True
            )
            t.start()
            self._client_threads.track(
                t, closer=lambda c=conn: _shutdown_close(c))
            if not self._running.is_set():
                # stop() may have snapshotted _clients and drained the
                # registry between accept and track — wake the worker
                _shutdown_close(conn)

    def _client_loop(self, client_id: int, conn: socket.socket) -> None:
        try:
            if self.handshake_timeout > 0:
                # un-handshaken connections must not linger forever
                conn.settimeout(self.handshake_timeout)
            while self._running.is_set():
                msg = recv_msg(conn)
                if msg is None:
                    break
                msg_type, payload = msg
                if msg_type is MsgType.CAPABILITY:
                    try:
                        text = payload.decode()
                    except UnicodeDecodeError:
                        # garbage capability token: answer with a typed
                        # ERROR and drop the link — never an unhandled
                        # exception killing this worker with conn open
                        send_msg(conn, MsgType.ERROR,
                                 b"bad capability payload: not utf-8")
                        break
                    # strip the wire-negotiation structure BEFORE the
                    # accept gate: an accept_caps that pattern-matches
                    # tensor structures must never see (or veto) it
                    caps, wire = transport.split_wire_caps(
                        parse_caps_string(text))
                    ok = self.accept_caps(caps) if self.accept_caps else True
                    if ok:
                        self._client_caps[client_id] = caps
                        reply = str(self.caps) if self.caps else str(caps)
                        fmt = transport.FORMAT_JSON
                        shm_ok = False
                        if wire is not None:
                            offered = transport.offered_formats(wire)
                            if transport.FORMAT_BINARY in offered:
                                fmt = transport.FORMAT_BINARY
                            shm_ok = (str(wire.get("shmhost", ""))
                                      == transport.same_host_token())
                            reply = transport.reply_caps(reply, fmt, shm_ok)
                        with self._lock:
                            self._client_wire[client_id] = fmt
                            self._client_shm[client_id] = shm_ok
                        wire_stats.note_connection(fmt)
                        send_msg(conn, MsgType.CAPABILITY, reply.encode())
                        conn.settimeout(None)  # handshake done: stream freely
                    else:
                        send_msg(conn, MsgType.ERROR,
                                 f"caps rejected: {caps}".encode())
                elif msg_type is MsgType.DATA:
                    limit = self.inbox_limit
                    if limit > 0 and self.inbox.qsize() >= limit:
                        # reference serversink limit: shed instead of
                        # queueing unboundedly under a slow pipeline
                        logger.warning(
                            "query server %d: inbox over limit %d, "
                            "dropping a frame from client %d",
                            self.port, limit, client_id)
                        continue
                    buf = self._decode_data(client_id, payload)
                    buf.meta["client_id"] = client_id
                    track = self._inflight.get(client_id)
                    if track is not None:
                        idx = track.recv
                        track.recv += 1  # EVERY frame, obs on or off
                        # the frame's index rides the meta so an answer
                        # producer that completes OUT of request order
                        # (scheduler bridge: an admission shed replies
                        # before an earlier in-flight frame) can pop its
                        # EXACT mark instead of trusting answer order
                        buf.meta["_qserve_idx"] = idx
                        if obs_context.TRACING or obs_profile.ACTIVE:
                            span = None
                            if obs_context.TRACING:
                                ctx = obs_context.TraceContext.from_meta(
                                    buf.meta.get("trace"))
                                if ctx is not None:
                                    span = obs_context.start_span(
                                        f"query.serve:c{client_id}",
                                        kind="serving", parent=ctx,
                                        attrs={"port": self.port,
                                               "client": client_id})
                            # under _lock: sender threads iterate this
                            # deque in _pop_mark_locked, and an unlocked
                            # append can surface there as "deque mutated
                            # during iteration"
                            with self._lock:
                                track.marks.append(
                                    (idx, time.monotonic(), span))
                    self.inbox.put(buf)
                elif msg_type is MsgType.EOS:
                    self.inbox.put(("eos", client_id))
        except (ConnectionError, OSError) as e:
            # TornFrameError lands here: a client cut mid-frame is a
            # typed disconnect on this worker only, never a hang
            logger.info("query server client %d dropped: %s", client_id, e)
        except ValueError as e:
            # the whole decode family: FrameError (NNSB), the NNST
            # codec's ValueError, UnicodeDecodeError — a poisoned frame
            # drops THIS link only, typed, never an unhandled exception
            logger.error("query server client %d sent a bad frame, "
                         "dropping it: %s", client_id, e)
        finally:
            with self._lock:
                self._clients.pop(client_id, None)
                self._client_caps.pop(client_id, None)
                track = self._inflight.pop(client_id, None)
                fmt = self._client_wire.pop(client_id, None)
                self._client_shm.pop(client_id, None)
                ring_out = self._client_ring_out.pop(client_id, None)
                rings_in = self._client_rings_in.pop(client_id, {})
            for _idx, _t0, span in (track.marks if track else ()):
                if span is not None:  # unanswered at disconnect
                    span.end("error:client-dropped")
            if ring_out is not None:
                # our s2c ring: reclaim slots the departed client never
                # released (generation bump retires its descriptors too)
                ring_out.reclaim()
                transport.detach_ring(ring_out)
            for r in rings_in.values():
                transport.detach_ring(r)
            if fmt is not None:
                wire_stats.drop_connection(fmt)
            try:
                conn.close()
            except OSError:
                pass

    def _decode_data(self, client_id: int, payload: bytes) -> Buffer:
        """Sniff-decode one inbound DATA payload: shm descriptor →
        binary frame → legacy NNST, by magic, independent of what the
        handshake negotiated (a client may fall back per frame)."""
        if transport.is_shm_descriptor(payload):
            name, slot, gen, nbytes = transport.unpack_descriptor(payload)
            with self._lock:
                rings = self._client_rings_in.setdefault(client_id, {})
                ring = rings.get(name)
                if ring is None:
                    ring = transport.attach_ring(name)
                    rings[name] = ring
            wire_stats.note_frame("shm", "rx", nbytes)
            return ring.read_frame(slot, gen, nbytes)
        if transport.is_binary_frame(payload):
            wire_stats.note_frame(transport.FORMAT_BINARY, "rx", len(payload))
            return transport.decode_frame(payload, copy=False)
        wire_stats.note_frame(transport.FORMAT_JSON, "rx", len(payload))
        return unpack_tensors(payload)

    # -- answer routing -----------------------------------------------------
    def _pop_mark_locked(self, client_id: int,
                         idx: Optional[int] = None):
        """(mark_for_this_answer, stale_spans). Call under ``_lock``.

        ``idx=None`` (in-order answer path — pipeline serversink):
        advances the client's answer index and pops the mark whose
        frame index matches it; marks walked PAST (frames that never
        got an answer: silent sheds, marks dropped by the deque bound)
        are discarded and their spans returned for the caller to end
        OUTSIDE the lock.

        ``idx`` given (scheduler bridge): answers can complete OUT of
        request order (an admission shed replies immediately while an
        earlier frame is still in a batch), so pop EXACTLY the mark
        with that frame index and leave the rest in flight — the
        counter scheme would shift every reordered answer's span and
        latency onto the wrong request."""
        track = self._inflight.get(client_id)
        if track is None:
            return None, ()
        marks = track.marks
        if idx is not None:
            for m in marks:
                if m[0] == idx:
                    marks.remove(m)
                    return m, ()
            return None, ()
        idx = track.sent
        track.sent += 1
        mark = None
        stale = []
        while marks and marks[0][0] <= idx:
            m = marks.popleft()
            if m[0] == idx:
                mark = m
                break
            if m[2] is not None:
                stale.append(m[2])
        return mark, stale

    def _encode_answer(self, client_id: int, out: Buffer):
        """Encode one outbound answer on the client's negotiated plane:
        shm descriptor when the same-host ring is on and has a free
        slot, else inline binary scatter-gather parts, else NNST."""
        with self._lock:
            fmt = self._client_wire.get(client_id, transport.FORMAT_JSON)
            shm_ok = self._client_shm.get(client_id, False)
            ring = self._client_ring_out.get(client_id)
        if fmt != transport.FORMAT_BINARY:
            payload = pack_tensors(out)
            wire_stats.note_frame(transport.FORMAT_JSON, "tx", len(payload))
            return payload
        try:
            parts = transport.encode_frame(out)
        except transport.FrameError:
            payload = pack_tensors(out)  # rank-8+ outlier: NNST fallback
            wire_stats.note_frame(transport.FORMAT_JSON, "tx", len(payload))
            return payload
        nbytes = transport.frame_nbytes(parts)
        if shm_ok:
            if ring is None:
                # first answer to this shm client: create our s2c ring,
                # its slots sized for this answer
                ring = transport.create_ring(
                    name=transport.ring_name(f"s{self.port}c{client_id}"),
                    slot_bytes=transport.slot_bytes_for(nbytes))
                with self._lock:
                    if client_id in self._client_wire:
                        self._client_ring_out[client_id] = ring
                    else:  # client vanished while we built it
                        transport.detach_ring(ring)
                        ring = None
            if ring is not None:
                desc = ring.write_frame(parts)
                if desc is not None:
                    wire_stats.note_frame("shm", "tx", nbytes)
                    return desc
                # ring full / oversize answer: inline binary fallback
        wire_stats.note_frame(transport.FORMAT_BINARY, "tx", nbytes)
        return parts

    def send(self, client_id: int, buf: Buffer,
             mark_idx: Optional[int] = None) -> bool:
        with self._lock:
            conn = self._clients.get(client_id)
            mark, stale = self._pop_mark_locked(client_id, mark_idx)
        for sp in stale:
            sp.end("error:unanswered")
        if conn is None:
            logger.warning("query server: no client %d for answer", client_id)
            if mark is not None and mark[2] is not None:
                mark[2].end("error:client-gone")
            return False
        meta = {k: v for k, v in buf.meta.items()
                if k not in ("client_id", "_qserve_idx")}
        # card tensors stay where they are: the encoder pulls each once
        out = buf.with_tensors(list(buf.tensors))
        out.meta = meta
        try:
            send_msg(conn, MsgType.DATA, self._encode_answer(client_id, out))
            ok = True
        except OSError:
            ok = False
        if mark is not None:
            _idx, t0, span = mark
            if span is not None:
                span.end("ok" if ok else "error:send-failed")
            if obs_profile.ACTIVE:
                obs_profile.record_request(
                    SERVE_SERIES, time.monotonic() - t0, ok=ok)
        return ok


# Shared per-id server table (reference tensor_query_server.c:76-117):
# serversrc and serversink with the same id use one QueryServer.
_servers: Dict[int, QueryServer] = {}
_server_refs: Dict[int, int] = {}
_servers_lock = threading.Lock()
# registration wakes lookup waiters (replaces the old 20 ms poll loop)
_servers_cond = threading.Condition(_servers_lock)


def get_shared_server(server_id: int, host: str = "127.0.0.1",
                      port: int = 0) -> QueryServer:
    """Acquire the shared server for ``server_id`` (refcounted: serversrc and
    serversink each acquire in start() and release in stop(), mirroring the
    reference's shared edge-handle table, tensor_query_server.c:76-117)."""
    with _servers_cond:
        srv = _servers.get(server_id)
        if srv is None:
            srv = QueryServer(host, port).start()
            _servers[server_id] = srv
            _server_refs[server_id] = 0
        _server_refs[server_id] += 1
        _servers_cond.notify_all()  # a serversink may be parked in lookup
        return srv


def lookup_shared_server(server_id: int, timeout: float = 5.0) -> QueryServer:
    """Acquire the EXISTING server for ``server_id``, waiting (on the
    table's condition — no polling) for its creator
    (tensor_query_serversrc) to register it. The serversink must never
    create the server itself: it doesn't know the host/port, and a
    sink-first start would pin the listener to an ephemeral port while the
    src's port= property gets silently ignored (reference: serversink looks
    up the handle serversrc created, tensor_query_server.c:76-117)."""
    deadline = time.monotonic() + timeout
    with _servers_cond:
        while True:
            srv = _servers.get(server_id)
            if srv is not None:
                _server_refs[server_id] += 1
                return srv
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                known = sorted(_servers)
                raise KeyError(
                    f"no tensor-query server with id {server_id} after "
                    f"{timeout:.1f}s — is a tensor_query_serversrc with "
                    f"the same id running? (registered server ids: "
                    f"{known if known else 'none'})")
            # bounded slice: stay responsive to a deadline that expires
            # between registrations without burning CPU in a poll loop
            _servers_cond.wait(min(remaining, 0.2))


def release_shared_server(server_id: int) -> None:
    with _servers_lock:
        if server_id not in _servers:
            return
        _server_refs[server_id] -= 1
        if _server_refs[server_id] > 0:
            return
        srv = _servers.pop(server_id)
        _server_refs.pop(server_id, None)
    srv.stop()
