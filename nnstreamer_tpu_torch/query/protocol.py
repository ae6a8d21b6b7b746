"""Tensor-query wire protocol (L5) — the counterpart of nnstreamer_tpu's
``query/protocol.py``: the same NNSQ framing, byte for byte.

Reference analog: the nnstreamer-edge transport consumed by
``tensor_query_*`` (gst/nnstreamer/tensor_query/tensor_query_client.c:204-692)
— TCP request/response with a CAPABILITY (caps string) handshake before data
(:386-460) and per-frame payloads of {ptr,size} memories + kv info. Our wire:

  frame  := magic "NNSQ" | u8 msg_type | u64 payload_len | payload
  types  := CAPABILITY (utf8 caps string), DATA (core/serialize tensor frame),
            EOS, ERROR (utf8 message)

Client-id routing meta (reference ``GstMetaQuery``, gst/nnstreamer/
tensor_meta.c) rides in the DATA frame's meta dict as ``client_id``.

Request-scoped trace propagation (obs/context.py) rides the same meta
dict under ``trace`` — ``{"trace_id", "span_id"}`` stamped by the sender
(``QueryClient.request`` or a fabric attempt) and consumed server-side
(``QueryServer.attach_scheduler``), so one
request is one trace across every process boundary. Fabric routing meta
(``fabric``: remaining deadline budget, idempotency key, attempt index)
is the third first-class meta field; all three are plain JSON and
survive ``pack_tensors``/``unpack_tensors`` unchanged.
"""
from __future__ import annotations

import enum
import socket
import struct
import sys as _sys
from typing import Optional, Tuple

MAGIC = b"NNSQ"
_HEADER = struct.Struct("<4sBQ")
MAX_PAYLOAD = 1 << 34  # sanity bound


class MsgType(enum.IntEnum):
    CAPABILITY = 1
    DATA = 2
    EOS = 3
    ERROR = 4


class TornFrameError(ConnectionError):
    """The peer vanished MID-frame: bytes arrived, then EOF before the
    frame completed. Distinct from a clean EOF between frames (recv_msg
    → None) — the old path returned None for both, so a connection cut
    during a payload read parsed as an orderly end-of-stream and the
    half-frame was silently dropped."""


# -- chaos hooks -------------------------------------------------------------
# Installed by elements/fault.py's NetworkChaos when armed; None (the
# default) costs one attribute read per send/connect and nothing else.
# send hook: (sock, msg_type) -> None, may sleep (delay) or raise
# ConnectionError (partition / injected connection kill); connect hook:
# (host, port) -> None, may raise ConnectionError (partition).
_send_fault_hook = None
_connect_fault_hook = None


def set_fault_hooks(send=None, connect=None) -> None:
    global _send_fault_hook, _connect_fault_hook
    _send_fault_hook = send
    _connect_fault_hook = connect


def check_connect_fault(host: str, port: int) -> None:
    """Called by transports before dialing; raises when the endpoint is
    chaos-partitioned."""
    hook = _connect_fault_hook
    if hook is not None:
        hook(host, port)


def send_msg(sock: socket.socket, msg_type: MsgType, payload=b"") -> None:
    """Send one frame; the payload may be bytes, a memoryview, or a LIST
    of scatter-gather parts (transport/frame.py's ``encode_frame``
    output). Header and every part go out as ONE ``sendmsg`` — one
    syscall, and neither a ``pack_tensors`` memoryview nor a binary
    frame's borrowed tensor views are ever copied into a concatenated
    bytes object."""
    hook = _send_fault_hook
    if hook is not None:
        hook(sock, msg_type)
    if isinstance(payload, (list, tuple)):
        parts = [memoryview(p).cast("B") for p in payload]
    elif payload:
        parts = [memoryview(payload).cast("B")]
    else:
        parts = []
    total = sum(p.nbytes for p in parts)
    header = _HEADER.pack(MAGIC, int(msg_type), total)
    _note_socket_bytes(_HEADER.size + total)
    if not parts:
        sock.sendall(header)
        return
    if not hasattr(sock, "sendmsg") or len(parts) >= 512:
        # non-POSIX socket objects (tests' fakes) and frames near the
        # IOV_MAX gather limit: sequential writes, still no copy
        sock.sendall(header)
        for p in parts:
            sock.sendall(p)
        return
    bufs = [header, *parts]
    sent = sock.sendmsg(bufs)
    if sent < len(header) + total:
        # rare partial gather-write (tiny socket buffer): stitch the
        # remainder with plain sendalls — cold path, correctness only
        for b in bufs:
            mv = memoryview(b).cast("B")
            if sent >= mv.nbytes:
                sent -= mv.nbytes
                continue
            sock.sendall(mv[sent:])
            sent = 0


def _note_socket_bytes(nbytes: int) -> None:
    """NNS_XFERCHECK ledger of bytes that actually HIT the socket
    (stage ``wire:socket``) — the shm path's zero-payload-over-TCP
    assertion diffs this against the codec stages. sys.modules lookup,
    not an import: one dict-get when the sanitizer is off."""
    _san = _sys.modules.get("nnstreamer_tpu_torch.analysis.sanitizer")
    if _san is not None and _san.XFER:
        _san.note_transfer("wire:socket", "host", nbytes)


def recv_msg(sock: socket.socket) -> Optional[Tuple[MsgType, bytes]]:
    """Blocking read of one frame. None ONLY on a clean EOF between
    frames; a connection that dies mid-header or mid-payload raises
    :class:`TornFrameError` (it used to read as a clean EOS, silently
    dropping the half-frame)."""
    header = _recv_exact(sock, _HEADER.size, "frame header")
    if header is None:
        return None
    magic, msg_type, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ConnectionError("bad tensor-query frame magic")
    if length > MAX_PAYLOAD:
        raise ConnectionError(f"oversized tensor-query payload ({length} bytes)")
    try:
        mt = MsgType(msg_type)
    except ValueError:
        # a skewed/corrupt header must surface as the protocol's typed
        # error, not a bare ValueError killing the reader loop
        raise ConnectionError(
            f"unknown tensor-query message type {msg_type}") from None
    payload = b""
    if length:
        payload = _recv_exact(sock, length, "payload")
        if payload is None:  # 0 of `length` bytes then EOF: torn too
            raise TornFrameError(
                f"connection closed before any of a {length}-byte payload")
    return mt, payload


def _recv_exact(sock: socket.socket, n: int, what: str) -> Optional[bytes]:
    """Read exactly ``n`` bytes. None on EOF at a frame boundary (zero
    bytes read); :class:`TornFrameError` on EOF after a partial read."""
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            if not chunks:
                return None
            got = n - remaining
            raise TornFrameError(
                f"connection closed mid-{what}: {got} of {n} bytes")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
