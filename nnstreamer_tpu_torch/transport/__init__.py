"""Zero-copy data plane (L5): binary wire format, shared-memory replica
transport, double-buffered device staging — the counterpart of
nnstreamer_tpu's ``transport`` package, with its exports.

Three legs, one contract — frames move by reference until a process or
device boundary forces exactly one accounted copy:

* :mod:`.frame` — the NNSB binary wire codec (fixed header + tensor
  table + compact meta sidecar) negotiated per connection during the
  query CAPABILITY handshake; JSON/NNST stays the fallback for old
  peers, and receive paths sniff the frame magic so a mixed fleet
  interoperates.
* :mod:`.shm` — single-writer slot rings in ``multiprocessing.
  shared_memory`` for same-host peers: tensors land in shm, only slot
  descriptors cross the socket, generation counters make peer death
  recoverable.
* :mod:`.staging` — the pinned double-buffered host→device staging
  of placed fused segments.
* :mod:`.stats` — the counters the ``nns_wire_*`` / ``nns_shm_*``
  metrics and the ``obs top`` TRANSPORT section render.

The ``NNS_XFERCHECK``/``NNS_LEAKCHECK`` sanitizers ledger the copies and
the ring attach/detach pairs at runtime.
"""
from . import stats
from .frame import (FORMAT_BINARY, FORMAT_JSON, FrameError,
                    MAX_META_BYTES, MAX_PAYLOAD_BYTES, MAX_TENSORS,
                    WIRE_MIME, decode_frame, encode_frame,
                    encode_frame_bytes, frame_nbytes, frame_overhead,
                    gather_parts,
                    is_binary_frame, offer_caps, offered_formats,
                    owning_message, owning_tagged, reply_caps,
                    split_wire_caps)
from .shm import (ShmRing, attach_ring, create_ring, detach_ring,
                  is_shm_descriptor, pack_descriptor, ring_name,
                  same_host_token, slot_bytes_for, unpack_descriptor)
from .staging import DoubleBufferedStager

__all__ = [
    "FORMAT_BINARY", "FORMAT_JSON", "FrameError",
    "MAX_META_BYTES", "MAX_PAYLOAD_BYTES", "MAX_TENSORS", "WIRE_MIME",
    "decode_frame", "encode_frame", "encode_frame_bytes", "frame_nbytes",
    "frame_overhead",
    "gather_parts", "is_binary_frame", "offer_caps", "offered_formats",
    "owning_message", "owning_tagged", "reply_caps", "split_wire_caps",
    "ShmRing", "attach_ring", "create_ring", "detach_ring",
    "is_shm_descriptor", "pack_descriptor", "ring_name",
    "same_host_token", "slot_bytes_for", "unpack_descriptor", "DoubleBufferedStager", "stats",
]
