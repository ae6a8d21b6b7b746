"""Shared-memory replica transport — tensor-slot rings (L5).

The counterpart of nnstreamer_tpu's ``transport/shm.py``: the same segment
layout, slot protocol and descriptors, so a port process and a reference
process can share a ring.

A same-host tensor-query pair (``ProcReplicaSet`` parent ↔ replica
child, or any client/server the handshake proves co-resident) shares
RAM; round-tripping tensor payloads through loopback TCP pays two
socket copies per frame for nothing. This module gives each direction
of a connection one single-writer ring of fixed-size slots inside one
``multiprocessing.shared_memory`` segment: the writer stages an NNSB
frame (transport/frame.py) into a free slot and only a ~60-byte slot
DESCRIPTOR crosses the socket — the ``NNS_XFERCHECK`` ledger proves the
payload bytes never do.

Slot protocol (single writer, single reader — the query link's
exclusive one-in-flight-request discipline):

* writer: scan ``state==FREE`` → bump the slot's GENERATION → copy the
  frame in → ``state=INFLIGHT`` → send the descriptor
  ``(segment, slot, generation, nbytes)``.
* reader: validate generation+state, decode with ``copy=True`` (the
  slot is recycled after release), ``release_slot`` → ``state=FREE``.
* no free slot / frame too big → writer returns None and the caller
  falls back to the inline binary wire (graceful, counted).

The generation counter is the crash story: when a peer is SIGKILLed
holding slots, the surviving writer calls :func:`ShmRing.reclaim` —
every in-flight slot is freed and its generation bumped, so a stale
descriptor that later surfaces fails validation instead of reading
recycled bytes.

Segment lifecycle is a lint-visible contract: :func:`create_ring` /
:func:`attach_ring` pair with :func:`detach_ring` (``# pairs-with:``,
NNL3xx) and report to the NNS_LEAKCHECK ledger, so an unbalanced
attach shows up both statically and at runtime.
"""
from __future__ import annotations

import os
import secrets
import struct
import sys as _sys
import threading
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

from .frame import FrameError, frame_nbytes
from . import stats

RING_MAGIC = b"NNSR"
RING_VERSION = 1
DESC_MAGIC = b"NNSD"

_RING_HEADER = struct.Struct("<4sHHIIQ")  # magic, ver, flags, nslots, rsvd, slot_bytes
_SLOT_HEADER = struct.Struct("<QQII")     # generation, nbytes, state, pad
_SLOT_STRIDE = 32                         # header size rounded for alignment
_DESC_HEAD = struct.Struct("<4sH")        # magic, name length
_DESC_TAIL = struct.Struct("<IQQ")        # slot, generation, nbytes

FREE = 0
INFLIGHT = 1

DEFAULT_SLOTS = 4
DEFAULT_SLOT_BYTES = 1 << 20
# a ring sized for a stream keeps this room for a frame's meta sidecar, and
# its slots stop at MAX_SLOT_BYTES: a larger frame goes inline (counted as
# fallback_oversize)
SLOT_META_ROOM = 64 << 10
MAX_SLOT_BYTES = 64 << 20

# segment names created by THIS process: a same-process attach (tests,
# loopback fixtures) must NOT unregister the creator's resource-tracker
# entry — only a foreign attach carries the 3.10 double-registration
_local_segments = set()


def _note_shm_bytes(stage: str, nbytes: int) -> None:
    """NNS_XFERCHECK accounting for slot copies (sys.modules lookup —
    transport/ stays import-light like core/serialize)."""
    _san = _sys.modules.get("nnstreamer_tpu_torch.analysis.sanitizer")
    if _san is not None and _san.XFER:
        _san.note_transfer(stage, "host", nbytes)


def _note_segment(event: str, name: str) -> None:
    """NNS_LEAKCHECK ledger half of the segment contract."""
    _san = _sys.modules.get("nnstreamer_tpu_torch.analysis.sanitizer")
    if _san is not None and _san.LEAK:
        if event == "acquire":
            _san.note_acquire("shm_segment", name)
        else:
            _san.note_release("shm_segment", name)


class ShmRing:
    """One single-writer slot ring in one shared-memory segment. Build
    through :func:`create_ring` / :func:`attach_ring` (the lint-paired
    acquire halves), release through :func:`detach_ring` / :meth:`close`."""

    def __init__(self, shm: shared_memory.SharedMemory, owner: bool,
                 nslots: int, slot_bytes: int):
        self._shm = shm
        self.owner = owner
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        self.name = shm.name
        self._mv: Optional[memoryview] = shm.buf
        self._payload_off = _RING_HEADER.size + nslots * _SLOT_STRIDE
        self._lock = threading.Lock()
        self._closed = False

    # -- slot header accessors ---------------------------------------------
    def _slot_off(self, slot: int) -> int:
        return _RING_HEADER.size + slot * _SLOT_STRIDE

    def _read_slot(self, slot: int) -> Tuple[int, int, int]:
        gen, nbytes, state, _pad = _SLOT_HEADER.unpack_from(
            self._mv, self._slot_off(slot))
        return gen, nbytes, state

    def _write_slot(self, slot: int, gen: int, nbytes: int,
                    state: int) -> None:
        _SLOT_HEADER.pack_into(self._mv, self._slot_off(slot),
                               gen, nbytes, state, 0)

    # -- writer side --------------------------------------------------------
    def write_frame(self, parts: List[memoryview]) -> Optional[bytes]:
        """Stage one frame into a free slot; returns the descriptor
        payload to send over the socket, or None when the ring is full
        or the frame exceeds the slot size (caller falls back to the
        inline wire)."""
        total = frame_nbytes(parts)
        if total > self.slot_bytes:
            stats.note_shm("fallback_oversize")
            return None
        with self._lock:
            if self._closed:
                return None
            slot = None
            for i in range(self.nslots):
                if self._read_slot(i)[2] == FREE:
                    slot = i
                    break
            if slot is None:
                stats.note_shm("fallback_full")
                return None
            gen = self._read_slot(slot)[0] + 1
            off = self._payload_off + slot * self.slot_bytes
            for p in parts:
                mv = memoryview(p).cast("B")
                self._mv[off:off + mv.nbytes] = mv
                off += mv.nbytes
            self._write_slot(slot, gen, total, INFLIGHT)
        stats.note_shm("slot_writes")
        stats.note_shm("bytes", total)
        _note_shm_bytes("shm:write", total)
        return pack_descriptor(self.name, slot, gen, total)

    def reclaim(self) -> int:
        """Free every in-flight slot and invalidate its outstanding
        descriptors (generation bump) — the writer's recovery after the
        reader died holding slots. Returns the number reclaimed."""
        freed = 0
        with self._lock:
            if self._closed:
                return 0
            for i in range(self.nslots):
                gen, _nbytes, state = self._read_slot(i)
                if state != FREE:
                    self._write_slot(i, gen + 1, 0, FREE)
                    freed += 1
        if freed:
            stats.note_shm("reclaimed_slots", freed)
        return freed

    # -- reader side --------------------------------------------------------
    def read_view(self, slot: int, gen: int, nbytes: int) -> memoryview:
        """Borrowed view of one in-flight slot's frame. Raises
        :class:`FrameError` on a stale descriptor (generation mismatch:
        the slot was reclaimed or recycled after a peer death)."""
        if not 0 <= slot < self.nslots or nbytes > self.slot_bytes:
            raise FrameError(
                f"shm descriptor out of range (slot {slot}, {nbytes}B)")
        cur_gen, cur_nbytes, state = self._read_slot(slot)
        if state != INFLIGHT or cur_gen != gen or cur_nbytes != nbytes:
            raise FrameError(
                f"stale shm descriptor for {self.name}[{slot}]: "
                f"gen {gen} vs {cur_gen}, state {state}")
        off = self._payload_off + slot * self.slot_bytes
        _note_shm_bytes("shm:read", nbytes)
        return self._mv[off:off + nbytes]

    def release_slot(self, slot: int) -> None:
        """Return a consumed slot to the writer's free scan."""
        gen, _nbytes, _state = self._read_slot(slot)
        self._write_slot(slot, gen, 0, FREE)

    def read_frame(self, slot: int, gen: int, nbytes: int):
        """Decode one in-flight slot into an owning :class:`Buffer` and
        free the slot. This is the reader's whole consume path: the
        borrowed slot view never escapes (an exported view pins the
        mapping past :meth:`close`)."""
        from .frame import decode_frame

        view = self.read_view(slot, gen, nbytes)
        try:
            return decode_frame(view, copy=True)
        finally:
            del view
            self.release_slot(slot)

    def in_flight(self) -> int:
        return sum(1 for i in range(self.nslots)
                   if self._read_slot(i)[2] != FREE)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Release the mapping; the creating side also unlinks the
        segment. Idempotent — the release half of the create/attach
        contract (NNL3xx ``pairs-with``, NNS_LEAKCHECK ledger)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._mv = None  # drop the exported buffer before close()
        _note_segment("release", self.name)
        stats.note_shm("segments_closed")
        try:
            self._shm.close()
        except (OSError, BufferError):
            # BufferError: a consumer still holds an exported slot view;
            # the mapping lingers until that view is collected, but the
            # unlink below still retires the name
            pass
        if self.owner:
            _local_segments.discard(self.name)
            try:
                self._shm.unlink()
            except (OSError, FileNotFoundError):
                pass

    @property
    def closed(self) -> bool:
        return self._closed


def ring_name(tag: str) -> str:
    """A collision-safe segment name: pid + random suffix, under the
    POSIX shm NAME_MAX budget."""
    return f"nns-{os.getpid()}-{tag}-{secrets.token_hex(4)}"


def slot_bytes_for(frame_bytes: int) -> int:
    """Slot size of a ring for a stream's frames of ``frame_bytes``: that
    plus room for meta, within ``[DEFAULT_SLOT_BYTES, MAX_SLOT_BYTES]``."""
    return min(max(DEFAULT_SLOT_BYTES, frame_bytes + SLOT_META_ROOM),
               MAX_SLOT_BYTES)


def create_ring(name: Optional[str] = None,  # pairs-with: detach_ring
                slots: int = DEFAULT_SLOTS,
                slot_bytes: int = DEFAULT_SLOT_BYTES) -> ShmRing:
    """Create (and own) one slot-ring segment. The creator is the
    single WRITER and the side that unlinks on close."""
    name = name or ring_name("ring")
    size = _RING_HEADER.size + slots * _SLOT_STRIDE + slots * slot_bytes
    shm = shared_memory.SharedMemory(name=name, create=True, size=size)
    _RING_HEADER.pack_into(shm.buf, 0, RING_MAGIC, RING_VERSION, 0,
                           slots, 0, slot_bytes)
    for i in range(slots):
        _SLOT_HEADER.pack_into(shm.buf, _RING_HEADER.size + i * _SLOT_STRIDE,
                               0, 0, FREE, 0)
    _local_segments.add(name)
    _note_segment("acquire", name)
    stats.note_shm("segments_created")
    return ShmRing(shm, owner=True, nslots=slots, slot_bytes=slot_bytes)


def attach_ring(name: str) -> ShmRing:  # pairs-with: detach_ring
    """Attach to a peer's ring as the READER. Python 3.10's attach path
    registers the segment with the resource tracker, which would
    erroneously unlink it when THIS process exits while the creator
    still serves from it — unregister right away (the creator owns
    unlink)."""
    shm = shared_memory.SharedMemory(name=name)
    if name not in _local_segments:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except (ImportError, AttributeError, KeyError):
            pass
    magic, version, _flags, nslots, _rsvd, slot_bytes = \
        _RING_HEADER.unpack_from(shm.buf, 0)
    if magic != RING_MAGIC or version != RING_VERSION:
        shm.close()
        raise FrameError(f"segment {name} is not an NNSR v{RING_VERSION} ring")
    # geometry from the segment header is wire-adjacent data: validate
    # it against the mapping's actual size before any slot arithmetic
    # trusts it (a corrupt header must not index past the segment)
    need = _RING_HEADER.size + nslots * (_SLOT_STRIDE + slot_bytes)
    if nslots == 0 or need > shm.size:
        shm.close()
        raise FrameError(
            f"segment {name}: ring header claims {nslots} slots of "
            f"{slot_bytes}B ({need}B) in a {shm.size}B segment")
    _note_segment("acquire", name)
    stats.note_shm("segments_attached")
    return ShmRing(shm, owner=False, nslots=nslots, slot_bytes=slot_bytes)


def detach_ring(ring: Optional[ShmRing]) -> None:
    """Release half of the ring contract; tolerates None and double
    release so teardown paths can call it unconditionally."""
    if ring is not None:
        ring.close()


# ---------------------------------------------------------------------------
# slot descriptors — the only thing the shm path puts on the socket
# ---------------------------------------------------------------------------

def pack_descriptor(name: str, slot: int, gen: int, nbytes: int) -> bytes:
    nb = name.encode()
    return (_DESC_HEAD.pack(DESC_MAGIC, len(nb)) + nb
            + _DESC_TAIL.pack(slot, gen, nbytes))


def unpack_descriptor(blob) -> Tuple[str, int, int, int]:
    """(segment name, slot, generation, nbytes); :class:`FrameError` on
    a torn descriptor."""
    view = memoryview(blob).cast("B")
    if view.nbytes < _DESC_HEAD.size:
        raise FrameError("torn shm descriptor header")
    magic, name_len = _DESC_HEAD.unpack_from(view, 0)
    if magic != DESC_MAGIC:
        raise FrameError("bad shm descriptor magic")
    need = _DESC_HEAD.size + name_len + _DESC_TAIL.size
    if view.nbytes < need:
        raise FrameError(
            f"torn shm descriptor: {view.nbytes} bytes, needed {need}")
    name = str(view[_DESC_HEAD.size:_DESC_HEAD.size + name_len], "utf-8")
    slot, gen, nbytes = _DESC_TAIL.unpack_from(
        view, _DESC_HEAD.size + name_len)
    return name, slot, gen, nbytes


def is_shm_descriptor(blob) -> bool:
    view = memoryview(blob)
    return view.nbytes >= 4 and bytes(view[:4]) == DESC_MAGIC


def same_host_token() -> str:
    """The token both ends compare during the handshake to prove they
    share /dev/shm. Hostname + boot id where available — two containers
    with the same hostname but separate shm namespaces differ in boot
    id far more often than they collide."""
    boot = ""
    try:
        with open("/proc/sys/kernel/random/boot_id") as fh:
            boot = fh.read().strip()[:8]
    except OSError:
        pass
    import socket as _socket

    return f"{_socket.gethostname()}-{boot}" if boot else _socket.gethostname()
