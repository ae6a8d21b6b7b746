#!/usr/bin/env python
"""NNS_WIREFUZZ for the PyTorch port: a structure-aware frame fuzzer for
nnstreamer_tpu_torch's wire data plane.

The port's counterpart of ``tools/wirefuzz.py``, with its CLI, its
seeded mutation catalog in the same order and its outcome classes. It
takes REAL encoded frames (NNSB binary frames from the port's
``transport.encode_frame``, legacy NNST frames from its ``pack_tensors``,
shm slot descriptors from a live ring), applies the catalog —

* truncation at every layout cut (header fields, table entries,
  payload boundaries, meta sidecar);
* a bit flip in every header and table field;
* every length/count/rank field inflated to extremes (u32/u64 max,
  one past the declared limit, off-by-one against the actual payload);
* version and magic skew (including cross-codec magics, so the
  sniff-decode path is exercised);
* meta-sidecar corruption (count inflation, unknown tag bytes);
* shm-specific: torn/stale/out-of-range descriptors, reclaimed
  generations, corrupt ring headers

— and drives every mutant through three surfaces: ``decode_frame`` /
``unpack_tensors`` directly, the shm ring read path, and a LIVE
``QueryServer`` connection. The gate is the hostile-peer contract
(docs/transport.md): every mutant must yield a TYPED error
(FrameError/ValueError family, or TornFrameError/ConnectionError at the
socket layer) within the deadline — never a hang, a crash (wrong
exception type, unhandled thread death), an OOM-scale allocation, or a
silent wrong decode (surviving mutants must pass re-encode parity).
Outcomes go to the port's scorekeeper
(``nnstreamer_tpu_torch.analysis.sanitizer``).

Everything is seeded (``--seed``): the catalog, the flip positions and
the payload contents are reproducible run to run, and the port's frames
are byte-equal to the reference's, so both tools build the same catalog
from the same seed. ``--device`` puts the baseline tensors of the
offline and shm surfaces on a card (``cuda``, the default) or keeps them
as CPU tensors (``cpu``); the encoder then pulls them from that device.
The live surface's frames come from the host, as a client's would.

Usage::

    python tools/wirefuzz_torch.py --device cpu          # full catalog
    python tools/wirefuzz_torch.py --device cpu --smoke  # reduced catalog
    python tools/wirefuzz_torch.py --json OUT.json       # on the card
"""
from __future__ import annotations

import argparse
import json
import random
import socket
import struct
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from nnstreamer_tpu_torch import transport  # noqa: E402
from nnstreamer_tpu_torch.analysis import sanitizer as san  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer  # noqa: E402
from nnstreamer_tpu_torch.core.serialize import (  # noqa: E402
    MAX_META_BYTES, MAX_PAYLOAD_BYTES, MAX_TENSORS, SPARSE_META_KEY,
    pack_tensors, unpack_tensors)
from nnstreamer_tpu_torch.query.protocol import (  # noqa: E402
    MAGIC as NNSQ_MAGIC, MsgType, recv_msg, send_msg)
from nnstreamer_tpu_torch.query.server import QueryServer  # noqa: E402

DEADLINE_S = 5.0          # per-mutant: typed error or bust
_HDR = 24                 # NNSB header size (<4sHHIId)
_TENT = 80                # NNSB table entry size (<BBHIQ8Q)
CAPS = "other/tensors,format=static,dimensions=8,types=float32"

# meta keys the server stamps/strips on its side of an echo
_ECHO_META = ("client_id", "_qserve_idx")


# ---------------------------------------------------------------------------
# baseline frames — real encoder output, never hand-built bytes
# ---------------------------------------------------------------------------

def _rich_meta(json_safe: bool) -> dict:
    meta = {
        "client_id": 7,
        "trace": {"trace_id": "ab12", "span_id": "cd34"},
        "note": "wirefuzz",
        "vals": [1, 2.5, None, True, "s"],
        "big": 1 << 80,
    }
    if not json_safe:
        # bytes meta rides the NNSB tagged sidecar only — the JSON
        # (NNST) codec rejects it by contract
        meta["blob"] = b"\x00\x01\x02"
    return meta


def _baseline_buffers(rng: random.Random, json_safe: bool,
                      device: Optional[str] = None
                      ) -> List[Tuple[str, Buffer]]:
    """The dense and the sparse baseline frame. With ``device`` their
    tensors become torch tensors on it (drawn from ``rng`` first, so the
    catalog does not depend on the device)."""
    dense = Buffer(
        [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
         (np.array([rng.randrange(256) for _ in range(16)], np.uint8)
          .reshape(4, 4))],
        pts=0.125)
    dense.meta.update(_rich_meta(json_safe))
    from nnstreamer_tpu_torch.elements.sparse import TensorSparseEnc

    coo = np.zeros((8, 16), np.float32)
    for _ in range(12):
        coo[rng.randrange(8), rng.randrange(16)] = rng.random()
    sparse = TensorSparseEnc().transform(Buffer([coo], pts=2.5))
    sparse.meta["client_id"] = 3
    out = [("dense", dense), ("sparse", sparse)]
    if device is not None:
        import torch

        out = [(tag, buf.with_tensors(
            [torch.from_numpy(np.asarray(t)).to(device)
             for t in buf.tensors])) for tag, buf in out]
    return out


# ---------------------------------------------------------------------------
# mutation catalog — NNSB frames
# ---------------------------------------------------------------------------

def nnsb_mutants(blob: bytes, rng: random.Random
                 ) -> Iterator[Tuple[str, bytes]]:
    """Structure-aware mutants of one encoded NNSB frame."""
    (n,) = struct.unpack_from("<I", blob, 8)
    (meta_len,) = struct.unpack_from("<I", blob, 12)
    table_end = _HDR + _TENT * n
    nbytes_list = [struct.unpack_from("<Q", blob, _HDR + _TENT * i + 8)[0]
                   for i in range(n)]
    meta_start = len(blob) - meta_len

    # truncations at every layout cut
    cuts = {0, 1, 4, 6, 8, 12, 16, _HDR - 1}
    for i in range(n + 1):
        cuts.add(_HDR + _TENT * i)
    poff = table_end
    for nb in nbytes_list:
        cuts.add(poff + nb // 2)
        poff += nb
        cuts.add(poff)
    cuts.update({meta_start, meta_start + 2, len(blob) - 1})
    for c in sorted(cuts):
        if 0 <= c < len(blob):
            yield f"truncate@{c}", blob[:c]

    # one bit flip per header field
    for name, off, size in [("magic", 0, 4), ("version", 4, 2),
                            ("flags", 6, 2), ("ntensors", 8, 4),
                            ("metalen", 12, 4), ("pts", 16, 8)]:
        b = bytearray(blob)
        bit = rng.randrange(size * 8)
        b[off + bit // 8] ^= 1 << (bit % 8)
        yield f"bitflip:{name}", bytes(b)

    # per-entry field corruption + length/count/rank inflation
    for i in range(n):
        base = _HDR + _TENT * i
        for name, off, fmt, vals in [
            ("dtype", 0, "<B", (0, 255)),
            ("rank", 1, "<B", (9, 255)),
            ("tflags", 2, "<H", (0xFFFF,)),
            ("extra", 4, "<I", (0xFFFFFFFF,)),
            ("nbytes", 8, "<Q",
             (0xFFFFFFFFFFFFFFFF, MAX_PAYLOAD_BYTES + 1,
              nbytes_list[i] + 1, max(nbytes_list[i] - 1, 0))),
            ("dim0", 16, "<Q", (1 << 40,)),
        ]:
            for v in vals:
                b = bytearray(blob)
                struct.pack_into(fmt, b, base + off, v)
                yield f"t{i}:{name}={v}", bytes(b)

    # header count inflation
    for v in (0xFFFFFFFF, MAX_TENSORS + 1, 0):
        b = bytearray(blob)
        struct.pack_into("<I", b, 8, v)
        yield f"ntensors={v}", bytes(b)
    for v in (0xFFFFFFFF, MAX_META_BYTES + 1, len(blob)):
        b = bytearray(blob)
        struct.pack_into("<I", b, 12, v)
        yield f"metalen={v}", bytes(b)

    # version / magic skew (incl. cross-codec magics: the sniff path)
    for v in (0, 2, 0xFFFF):
        b = bytearray(blob)
        struct.pack_into("<H", b, 4, v)
        yield f"version={v}", bytes(b)
    for m in (b"NNST", b"NNSQ", b"XXXX"):
        yield f"magic={m.decode()}", m + blob[4:]

    # payload content corruption: decodes CLEAN (no checksum by design) —
    # the parity check proves the corrupt bytes round-trip faithfully
    if nbytes_list and nbytes_list[0]:
        b = bytearray(blob)
        b[table_end + rng.randrange(nbytes_list[0])] ^= 0x40
        yield "bitflip:payload", bytes(b)

    # meta-sidecar corruption
    if meta_len >= 4:
        b = bytearray(blob)
        struct.pack_into("<I", b, meta_start, 0xFFFFFFFF)
        yield "meta:count=max", bytes(b)
    if meta_len > 10:
        b = bytearray(blob)
        b[meta_start + 9] = 0x7A  # 'z': not a tag the codec knows
        yield "meta:badtag", bytes(b)


def nnst_mutants(blob: bytes, rng: random.Random
                 ) -> Iterator[Tuple[str, bytes]]:
    """Mutants of one legacy NNST frame (MAGIC + <HIdI> header @4)."""
    for c in (0, 2, 4, 6, 10, 18, 22, len(blob) // 2, len(blob) - 1):
        if 0 <= c < len(blob):
            yield f"truncate@{c}", blob[:c]
    for v in (0, 99, 0xFFFF):
        b = bytearray(blob)
        struct.pack_into("<H", b, 4, v)
        yield f"version={v}", bytes(b)
    for v in (0xFFFFFFFF, MAX_TENSORS + 1):
        b = bytearray(blob)
        struct.pack_into("<I", b, 6, v)
        yield f"ntensors={v}", bytes(b)
    b = bytearray(blob)
    struct.pack_into("<I", b, 18, 0xFFFFFFFF)
    yield "metalen=max", bytes(b)
    yield "magic=NNSB", b"NNSB" + blob[4:]
    for i in range(3):  # seeded body flips: typed or parity-clean
        b = bytearray(blob)
        b[22 + rng.randrange(len(blob) - 22)] ^= 1 << rng.randrange(8)
        yield f"bitflip:body{i}", bytes(b)


# ---------------------------------------------------------------------------
# outcome classification
# ---------------------------------------------------------------------------

def _buffers_equal(a: Buffer, b: Buffer) -> bool:
    ta, tb = a.as_numpy().tensors, b.as_numpy().tensors
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        eq = (np.array_equal(x, y, equal_nan=True)
              if np.issubdtype(x.dtype, np.floating)
              else np.array_equal(x, y))
        if not eq:
            return False
    skip = set(_ECHO_META) | {SPARSE_META_KEY}
    ka = {k: v for k, v in a.meta.items() if k not in skip}
    kb = {k: v for k, v in b.meta.items() if k not in skip}
    return ka == kb


def _roundtrip_parity(decoder: Callable[[bytes], Buffer],
                      encoder: Callable[[Buffer], bytes],
                      buf: Buffer) -> bool:
    """A surviving mutant must be SELF-consistent: re-encoding its decode
    and decoding again reproduces the same buffer — corruption the codec
    cannot represent must never survive silently."""
    try:
        return _buffers_equal(buf, decoder(encoder(buf)))
    except (ValueError, TypeError):
        return False


def drive(surface: str, mutation: str, fn: Callable[[], Optional[Buffer]],
          parity: Optional[Callable[[Buffer], bool]] = None,
          deadline: float = DEADLINE_S) -> str:
    """Run one mutant, classify its fate, report to the scorekeeper."""
    t0 = time.monotonic()
    outcome, detail = "clean", ""
    try:
        result = fn()
    except (ValueError, ConnectionError) as e:
        # the typed contract: FrameError is a ValueError, TornFrameError
        # is a ConnectionError — anything in these families is a win
        outcome, detail = "typed", f"{type(e).__name__}: {e}"
    except Exception as e:  # noqa: BLE001 - the whole point: classify it
        outcome, detail = "crash", f"{type(e).__name__}: {e}"
    else:
        if parity is not None and result is not None and not parity(result):
            outcome = "silent"
            detail = "decode survived but failed re-encode parity"
    elapsed = time.monotonic() - t0
    if elapsed > deadline:
        outcome, detail = "hang", f"{elapsed:.2f}s > {deadline:.2f}s"
    san.note_mutant(surface, mutation, outcome, detail)
    return outcome


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------

def run_decode_surface(rng: random.Random, smoke: bool,
                       device: Optional[str] = None) -> None:
    """NNSB ``decode_frame`` + legacy NNST ``unpack_tensors``, offline."""
    baselines = _baseline_buffers(rng, json_safe=False, device=device)
    if smoke:
        baselines = baselines[:1]

    def nnsb_parity(buf: Buffer) -> bool:
        return _roundtrip_parity(
            lambda b: transport.decode_frame(b),
            lambda x: bytes(transport.encode_frame_bytes(x)), buf)

    for tag, buf in baselines:
        blob = bytes(transport.encode_frame_bytes(buf))
        assert _buffers_equal(buf, transport.decode_frame(blob)), tag
        for mutation, mutant in nnsb_mutants(blob, rng):
            drive("decode_frame", f"{tag}:{mutation}",
                  lambda m=mutant: transport.decode_frame(m),
                  parity=nnsb_parity)

    def nnst_parity(buf: Buffer) -> bool:
        return _roundtrip_parity(
            unpack_tensors, lambda x: bytes(pack_tensors(x)), buf)

    for tag, buf in _baseline_buffers(rng, json_safe=True, device=device):
        if smoke and tag != "dense":
            continue
        blob = bytes(pack_tensors(buf))
        for mutation, mutant in nnst_mutants(blob, rng):
            drive("unpack_tensors", f"{tag}:{mutation}",
                  lambda m=mutant: unpack_tensors(m),
                  parity=nnst_parity)


def run_shm_surface(rng: random.Random,
                    device: Optional[str] = None) -> None:
    """Torn/stale/out-of-range descriptors and corrupt ring headers
    against a real ring."""
    buf = _baseline_buffers(rng, json_safe=False, device=device)[0][1]
    parts = transport.encode_frame(buf)
    ring = transport.create_ring(slots=2, slot_bytes=1 << 16)
    try:
        desc = ring.write_frame(parts)
        assert desc is not None
        name, slot, gen, nbytes = transport.unpack_descriptor(desc)

        # descriptor byte mutants through the unpack path
        name_len = struct.unpack_from("<H", desc, 4)[0]
        for c in sorted({0, 2, 4, 6, 6 + name_len // 2, 6 + name_len,
                         len(desc) - 1}):
            drive("shm_ring", f"desc:truncate@{c}",
                  lambda m=desc[:c]: transport.unpack_descriptor(m))
        drive("shm_ring", "desc:magic=NNSB",
              lambda: transport.unpack_descriptor(b"NNSB" + desc[4:]))
        b = bytearray(desc)
        struct.pack_into("<H", b, 4, 0xFFFF)
        drive("shm_ring", "desc:namelen=max",
              lambda m=bytes(b): transport.unpack_descriptor(m))

        # semantic mutants through the ring read path
        drive("shm_ring", "desc:slot+5",
              lambda: ring.read_frame(slot + 5, gen, nbytes))
        drive("shm_ring", "desc:gen+1",
              lambda: ring.read_frame(slot, gen + 1, nbytes))
        drive("shm_ring", "desc:nbytes+1",
              lambda: ring.read_frame(slot, gen, nbytes + 1))
        drive("shm_ring", "desc:nbytes=slotmax+1",
              lambda: ring.read_frame(slot, gen, ring.slot_bytes + 1))
        # the honest descriptor still decodes (and frees the slot)
        drive("shm_ring", "desc:valid",
              lambda: ring.read_frame(slot, gen, nbytes))

        # stale generation: write, reclaim (peer-death recovery), read
        desc2 = ring.write_frame(parts)
        assert desc2 is not None
        _n2, slot2, gen2, nb2 = transport.unpack_descriptor(desc2)
        ring.reclaim()
        drive("shm_ring", "desc:reclaimed",
              lambda: ring.read_frame(slot2, gen2, nb2))

        # corrupt ring headers against the attach path
        victim = transport.create_ring(slots=1, slot_bytes=1024)
        try:
            victim._shm.buf[0:4] = b"XXXX"
            drive("shm_ring", "ring:badmagic",
                  lambda: transport.attach_ring(victim.name))
            victim._shm.buf[0:4] = b"NNSR"
            struct.pack_into("<I", victim._shm.buf, 8, 0xFFFF)  # nslots
            drive("shm_ring", "ring:geometry",
                  lambda: transport.attach_ring(victim.name))
        finally:
            transport.detach_ring(victim)
    finally:
        transport.detach_ring(ring)


def run_live_surface(rng: random.Random, smoke: bool) -> None:
    """Every mutant through one live QueryServer connection: a poisoned
    frame must drop THAT link with a typed error; the server must stay
    alive and keep serving fresh connections."""
    thread_crashes: List[str] = []
    old_hook = threading.excepthook
    threading.excepthook = lambda hargs: thread_crashes.append(
        f"{hargs.thread.name}: {hargs.exc_type.__name__}: {hargs.exc_value}")

    srv = QueryServer().start()
    stop_echo = threading.Event()

    def _echo_loop() -> None:
        import queue as _q

        while not stop_echo.is_set():
            try:
                item = srv.inbox.get(timeout=0.1)
            except _q.Empty:
                continue
            if isinstance(item, tuple):  # ("eos", cid)
                continue
            try:
                cid = item.meta.pop("client_id")
                idx = item.meta.pop("_qserve_idx", None)
                srv.send(cid, item, mark_idx=idx)
            except Exception as e:  # noqa: BLE001 - scored, not fatal
                san.note_mutant("query_server", "echo-path", "crash",
                                f"{type(e).__name__}: {e}")

    echo = threading.Thread(target=_echo_loop, name="wirefuzz-echo",
                            daemon=True)
    echo.start()

    def _dial() -> socket.socket:
        s = socket.create_connection((srv.host, srv.port),
                                     timeout=DEADLINE_S)
        s.settimeout(DEADLINE_S)
        send_msg(s, MsgType.CAPABILITY, CAPS.encode())
        msg = recv_msg(s)
        assert msg is not None and msg[0] is MsgType.CAPABILITY
        return s

    def _poke(payload: bytes, raw: bool = False) -> Optional[Buffer]:
        """Handshake, send one (mutant) DATA frame, await the echo.
        Typed drop → ConnectionError; clean echo → decoded Buffer."""
        s = _dial()
        try:
            if raw:
                try:
                    s.sendall(payload)
                    # our half is complete: EOF lets the server classify
                    # a torn frame instead of waiting for bytes we never
                    # send
                    s.shutdown(socket.SHUT_WR)
                except socket.timeout:
                    raise
                except OSError as e:
                    # ENOTCONN/EPIPE: the server already tore the link
                    # down mid-send — that IS the typed drop
                    raise ConnectionError(f"link dropped during send: {e}")
            else:
                send_msg(s, MsgType.DATA, payload)
            try:
                msg = recv_msg(s)
            except socket.timeout:
                raise TimeoutError("no echo and no close")  # → crash bin
            if msg is None:
                raise ConnectionError("server dropped the link (typed)")
            if msg[0] is MsgType.ERROR:
                raise ValueError(msg[1].decode(errors="replace"))
            return transport.decode_frame(msg[1]) \
                if transport.is_binary_frame(msg[1]) \
                else unpack_tensors(msg[1])
        finally:
            s.close()

    try:
        # the live pool must be JSON-safe: a mutant that decodes clean is
        # echoed back through the server's (JSON) answer encoder
        _tag, base = _baseline_buffers(rng, json_safe=True)[0]
        blob = bytes(transport.encode_frame_bytes(base))
        pool = list(nnsb_mutants(blob, rng))
        if smoke:
            pool = pool[:: max(1, len(pool) // 20)]
        for mutation, mutant in pool:
            # no parity here: the echo pipeline re-encodes server-side,
            # so a returned Buffer already proves a coherent decode
            drive("query_server", f"data:{mutation}",
                  lambda m=mutant: _poke(m))

        # NNSQ protocol-header mutants (raw bytes on the socket)
        good = bytes(pack_tensors(base))
        hdr = struct.Struct("<4sBQ")
        for mutation, rawb in [
            ("nnsq:badmagic", b"XXXX" + hdr.pack(NNSQ_MAGIC, 2,
                                                 len(good))[4:] + good),
            ("nnsq:type=99", hdr.pack(NNSQ_MAGIC, 99, len(good)) + good),
            ("nnsq:len=max", hdr.pack(NNSQ_MAGIC, 2, 1 << 40)),
            ("nnsq:torn-header", hdr.pack(NNSQ_MAGIC, 2, len(good))[:7]),
            ("nnsq:torn-payload",
             hdr.pack(NNSQ_MAGIC, 2, len(good)) + good[:10]),
        ]:
            drive("query_server", mutation,
                  lambda r=rawb: _poke(r, raw=True))

        # garbage capability token: typed ERROR reply, zero round trips
        def _bad_caps() -> None:
            s = socket.create_connection((srv.host, srv.port),
                                         timeout=DEADLINE_S)
            s.settimeout(DEADLINE_S)
            try:
                send_msg(s, MsgType.CAPABILITY, b"\xff\xfe\x00garbage")
                msg = recv_msg(s)
                if msg is not None and msg[0] is MsgType.ERROR:
                    raise ValueError(msg[1].decode(errors="replace"))
                if msg is None:
                    raise ConnectionError("dropped pre-handshake (typed)")
            finally:
                s.close()

        drive("query_server", "caps:garbage", _bad_caps)

        # the server survived the whole catalog: a fresh well-formed
        # client still gets service
        out = _poke(bytes(transport.encode_frame_bytes(base)))
        assert out is not None and _buffers_equal(base, out), \
            "server unhealthy after fuzz run"
    finally:
        stop_echo.set()
        echo.join(timeout=2.0)
        srv.stop()
        threading.excepthook = old_hook
    for crash in thread_crashes:
        san.note_mutant("query_server", "thread-death", "crash", crash)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the scoreboard to PATH")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced catalog (CI entrypoint check)")
    ap.add_argument("--device", default="cuda",
                    help="where the offline and shm surfaces' baseline "
                         "tensors live: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            ap.error(f"--device {args.device}: no CUDA card here "
                     "(pass --device cpu)")

    san.enable_wirefuzz()
    try:
        rng = random.Random(args.seed)
        run_decode_surface(rng, args.smoke, args.device)
        run_shm_surface(rng, args.device)
        run_live_surface(rng, args.smoke)
        report = san.wirefuzz_report()
    finally:
        san.disable_wirefuzz()

    report["seed"] = args.seed
    report["device"] = args.device
    ok = (report["mutants_total"] > 0 and not report["violations"]
          and report["typed"] + report["clean"] == report["mutants_total"])
    report["verdict"] = "PASS" if ok else "FAIL"
    for surface, per in sorted(report["surfaces"].items()):
        total = sum(per.values())
        print(f"  {surface:14s} {total:4d} mutants  "
              f"typed={per.get('typed', 0)} clean={per.get('clean', 0)} "
              f"hang={per.get('hang', 0)} crash={per.get('crash', 0)} "
              f"silent={per.get('silent', 0)}")
    print(f"wirefuzz: {report['mutants_total']} mutants, "
          f"{report['typed']} typed, {report['clean']} clean, "
          f"{report['hangs']} hangs, {report['crashes']} crashes, "
          f"{report['silent']} silent -> {report['verdict']}")
    for v in report["violations"][:10]:
        print(f"  VIOLATION {v['surface']}/{v['mutation']}: "
              f"{v['outcome']} {v['detail']}")
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2,
                                              sort_keys=True) + "\n")
        print(f"wrote {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
