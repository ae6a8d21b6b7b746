"""The port's data plane (``transport/{frame,shm,stats}.py``,
``query/protocol.py``) against nnstreamer_tpu's, on seeded numpy inputs.

* NNSB frames, shm slot descriptors and NNSQ messages are byte-equal to
  the reference's for the same buffer (float32, uint8, int32, int64,
  float64, bool, float16 and bfloat16; dense and sparse), and each
  package decodes the other's frames;
* a ring created by one package is read by the other (bfloat16 included);
* the cases of the reference's ``tests/test_transport.py`` on the port:
  codec round trips and truncation, torn frames at the socket layer, the
  negotiation matrix with a legacy JSON-only server, the shm ring's
  lifecycle, byte parity binary vs JSON vs shm over the fusion parity
  lines, and the transfer ledger's proof that shm moves descriptors only;
* a mixed fleet in both directions: a reference ``QueryClient`` against a
  port ``QueryServer`` and a port client against a reference server, over
  JSON, NNSB and NNSB with shm.

Every wait is bounded (socket timeouts, queue gets, joins)."""
import pathlib
import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu import transport as R_transport
from nnstreamer_tpu.core import Buffer as RBuffer
from nnstreamer_tpu.core import parse_caps_string as r_parse_caps
from nnstreamer_tpu.core.tensors import TensorSpec as RSpec
from nnstreamer_tpu.query import protocol as R_protocol
from nnstreamer_tpu.query.client import QueryClient as RQueryClient
from nnstreamer_tpu.query.server import QueryServer as RQueryServer
from nnstreamer_tpu_torch import transport
from nnstreamer_tpu_torch.analysis import sanitizer
from nnstreamer_tpu_torch.core import Buffer, parse_caps_string
from nnstreamer_tpu_torch.core.serialize import pack_tensors, unpack_tensors
from nnstreamer_tpu_torch.core.tensors import DataType, TensorSpec
from nnstreamer_tpu_torch.query import protocol
from nnstreamer_tpu_torch.query.client import QueryClient
from nnstreamer_tpu_torch.query.protocol import (MsgType, TornFrameError,
                                                 recv_msg, send_msg)
from nnstreamer_tpu_torch.query.server import QueryServer
from nnstreamer_tpu_torch.transport.frame import (FrameError, decode_frame,
                                                  encode_frame,
                                                  encode_frame_bytes,
                                                  gather_parts,
                                                  is_binary_frame,
                                                  owning_message,
                                                  owning_tagged)

CAPS = "other/tensors,format=static,dimensions=8,types=float32"
WAIT = 10.0


@pytest.fixture(autouse=True)
def _no_chaos_hooks():
    """Disarm fault hooks a prior test left behind in either package (the
    chaos send hook calls ``getpeername()[1]``, which AF_UNIX pairs lack)."""
    saved = [(m._send_fault_hook, m._connect_fault_hook)
             for m in (protocol, R_protocol)]
    protocol.set_fault_hooks(None, None)
    R_protocol.set_fault_hooks(None, None)
    yield
    protocol.set_fault_hooks(*saved[0])
    R_protocol.set_fault_hooks(*saved[1])


def _rich_arrays():
    rng = np.random.default_rng(7)
    return [rng.random((2, 3, 4)).astype(np.float32),
            rng.integers(0, 255, (5,), dtype=np.uint8),
            rng.integers(-100, 100, (1, 7)).astype(np.int64),
            np.asarray([3.5], np.float64)]


_META = {"client_id": 3, "note": "héllo ∑",
         "nested": {"k": [1, 2.5, None, True, "x"]}, "big": 2**48, "neg": -7}


def _rich_buffer():
    return Buffer(_rich_arrays(), pts=0.125, meta=dict(_META))


def _bytes_of(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        if t.dtype is torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


# ---------------------------------------------------------------------------
# byte parity with the reference
# ---------------------------------------------------------------------------

# (port tensor, reference array) from one seeded numpy draw
def _pair(dtype: str):
    rng = np.random.default_rng(11)
    if dtype == "bfloat16":
        words = rng.integers(0, 1 << 16, (3, 5), dtype=np.uint16)
        # drop NaN patterns: NaN payloads need not survive every copy
        words[(words & 0x7F80) == 0x7F80] = 0x3F80
        port = torch.from_numpy(words.view(np.int16).copy()).view(
            torch.bfloat16)
        return port, words.view(ml_dtypes.bfloat16)
    if dtype == "bool":
        a = rng.integers(0, 2, (4, 3)).astype(bool)
    elif dtype.startswith("float"):
        a = rng.standard_normal((2, 3, 4)).astype(dtype)
    else:
        a = rng.integers(0, 100, (6, 2)).astype(dtype)
    return a, a


DTYPES = ["float32", "uint8", "int32", "int64", "float64", "bool", "float16",
          "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_nnsb_frame_bytes_equal_the_reference(dtype):
    port_t, ref_a = _pair(dtype)
    got = bytes(encode_frame_bytes(Buffer([port_t], pts=0.5,
                                          meta=dict(_META))))
    want = bytes(R_transport.encode_frame_bytes(
        RBuffer([ref_a], pts=0.5, meta=dict(_META))))
    assert got == want
    # each package decodes the other's frame to the same bytes
    back = decode_frame(want)
    assert _bytes_of(back.tensors[0]) == ref_a.tobytes()
    assert tuple(back.tensors[0].shape) == ref_a.shape
    if dtype == "bfloat16":
        assert back.tensors[0].dtype is torch.bfloat16
    rback = R_transport.decode_frame(got)
    assert np.asarray(rback.tensors[0]).tobytes() == ref_a.tobytes()
    assert back.meta == rback.meta and back.pts == rback.pts


def test_card_style_torch_tensors_encode_like_numpy():
    """CPU torch tensors (what a filter's outputs are off the card) give
    the numpy array's frame."""
    a = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    assert bytes(encode_frame_bytes(Buffer([torch.from_numpy(a)]))) == \
        bytes(R_transport.encode_frame_bytes(RBuffer([a])))


def test_sparse_frame_bytes_equal_the_reference():
    idx = np.asarray([0, 3, 7], np.int32)
    vals = np.asarray([1.5, -2.0, 4.25], np.float32)
    got = bytes(encode_frame_bytes(Buffer(
        [idx, vals], meta={"sparse_specs": [TensorSpec((2, 4), "float32")]})))
    want = bytes(R_transport.encode_frame_bytes(RBuffer(
        [idx, vals], meta={"sparse_specs": [RSpec((2, 4), "float32")]})))
    assert got == want
    out = decode_frame(want)
    assert out.tensors[0].tolist() == [0, 3, 7]
    assert out.meta["sparse_specs"][0].shape == (2, 4)


def test_sparse_bfloat16_values_round_trip():
    idx = np.asarray([1, 2], np.int32)
    vals = torch.tensor([1.5, -3.0], dtype=torch.bfloat16)
    frame = encode_frame_bytes(Buffer(
        [idx, vals], meta={"sparse_specs": [TensorSpec((4,), "bfloat16")]}))
    want = R_transport.encode_frame_bytes(RBuffer(
        [idx, np.asarray([1.5, -3.0], ml_dtypes.bfloat16)],
        meta={"sparse_specs": [RSpec((4,), "bfloat16")]}))
    assert bytes(frame) == bytes(want)
    out = decode_frame(frame)
    assert out.tensors[1].dtype is torch.bfloat16
    assert out.tensors[1].tolist() == [1.5, -3.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shm_descriptor_and_slot_bytes_equal_the_reference(dtype):
    port_t, ref_a = _pair(dtype)
    assert transport.pack_descriptor("nns-x", 2, 9, 640) == \
        R_transport.pack_descriptor("nns-x", 2, 9, 640)
    ring = transport.create_ring(slots=2)  # pairs-with: detach_ring
    rring = R_transport.create_ring(slots=2)  # pairs-with: detach_ring
    try:
        d = ring.write_frame(encode_frame(Buffer([port_t])))
        rd = rring.write_frame(R_transport.encode_frame(RBuffer([ref_a])))
        _n, slot, gen, nbytes = transport.unpack_descriptor(d)
        assert (slot, gen, nbytes) == R_transport.unpack_descriptor(rd)[1:]
        got = bytes(ring.read_view(slot, gen, nbytes))
        want = bytes(rring.read_view(slot, gen, nbytes))
        assert got == want
    finally:
        transport.detach_ring(ring)
        R_transport.detach_ring(rring)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_ring_is_shared_across_packages(writer):
    port_t, ref_a = _pair("bfloat16")
    if writer == "port":
        ring = transport.create_ring()  # pairs-with: detach_ring
        reader = R_transport.attach_ring(ring.name)  # pairs-with: detach_ring
        desc = ring.write_frame(encode_frame(Buffer([port_t], meta={"n": 1})))
    else:
        ring = R_transport.create_ring()  # pairs-with: detach_ring
        reader = transport.attach_ring(ring.name)  # pairs-with: detach_ring
        desc = ring.write_frame(R_transport.encode_frame(
            RBuffer([ref_a], meta={"n": 1})))
    try:
        _n, slot, gen, nbytes = transport.unpack_descriptor(desc)
        out = reader.read_frame(slot, gen, nbytes)
        assert _bytes_of(out.tensors[0]) == ref_a.tobytes()
        assert out.meta == {"n": 1}
        assert ring.in_flight() == 0
    finally:
        reader.close()
        ring.close()


@pytest.mark.parametrize("mtype", ["CAPABILITY", "DATA", "EOS", "ERROR"])
def test_nnsq_messages_byte_equal_the_reference(mtype):
    payload = {"CAPABILITY": CAPS.encode(), "EOS": b"",
               "ERROR": b"caps rejected: x",
               "DATA": None}[mtype]
    if payload is None:
        got_payload = encode_frame(_rich_buffer())
        want_payload = R_transport.encode_frame(
            RBuffer(_rich_arrays(), pts=0.125, meta=dict(_META)))
    else:
        got_payload = want_payload = payload
    out = []
    for mod, pl in ((protocol, got_payload), (R_protocol, want_payload)):
        a, b = socket.socketpair()
        b.settimeout(WAIT)
        try:
            mod.send_msg(a, mod.MsgType[mtype], pl)
            a.close()
            chunks = []
            while True:
                c = b.recv(1 << 16)
                if not c:
                    break
                chunks.append(c)
            out.append(b"".join(chunks))
        finally:
            b.close()
    assert out[0] == out[1]
    assert out[0][:4] == b"NNSQ"


# ---------------------------------------------------------------------------
# NNSB codec (the reference's TestFrameCodec)
# ---------------------------------------------------------------------------

class TestFrameCodec:
    def test_dense_roundtrip(self):
        buf = _rich_buffer()
        out = decode_frame(encode_frame_bytes(buf))
        assert len(out.tensors) == len(buf.tensors)
        for a, b in zip(buf.tensors, out.tensors):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.ascontiguousarray(a).tobytes() == b.tobytes()
        assert out.pts == buf.pts
        assert out.meta == buf.meta

    def test_rank0_normalizes_like_nnst(self):
        buf = Buffer([np.asarray(3.5, np.float64)])
        via_bin = decode_frame(encode_frame_bytes(buf))
        via_json = unpack_tensors(pack_tensors(buf))
        assert via_bin.tensors[0].shape == via_json.tensors[0].shape
        assert via_bin.tensors[0].tobytes() == via_json.tensors[0].tobytes()

    def test_none_pts_and_empty_meta(self):
        out = decode_frame(encode_frame_bytes(Buffer([np.zeros(4, np.float32)])))
        assert out.pts is None
        assert out.meta == {}

    def test_parts_are_zero_copy_views(self):
        arr = np.arange(16, dtype=np.float32)
        parts = encode_frame(Buffer([arr]))
        payload = [p for p in parts if p.nbytes == arr.nbytes]
        assert payload, "tensor payload part missing"
        arr[0] = 99.0
        assert np.frombuffer(payload[0], np.float32)[0] == 99.0

    def test_cpu_torch_payload_is_a_view_too(self):
        t = torch.arange(8, dtype=torch.float32)
        parts = encode_frame(Buffer([t]))
        t[0] = 42.0
        assert np.frombuffer(parts[1], np.float32)[0] == 42.0

    def test_zero_copy_decode_keeps_the_owner_alive(self):
        blob = bytearray(encode_frame_bytes(Buffer(
            [torch.tensor([1.0, 2.0], dtype=torch.bfloat16)])))
        out = decode_frame(blob, copy=False)
        del blob
        assert out.tensors[0].tolist() == [1.0, 2.0]

    def test_magic_sniff(self):
        blob = encode_frame_bytes(Buffer([np.zeros(2, np.float32)]))
        assert is_binary_frame(blob)
        assert not is_binary_frame(pack_tensors(
            Buffer([np.zeros(2, np.float32)])))
        assert not is_binary_frame(b"NN")

    def test_rank_over_8_rejected(self):
        with pytest.raises(FrameError):
            encode_frame(Buffer([np.zeros((1,) * 9, np.float32)]))

    def test_truncation_is_typed_at_every_cut(self):
        blob = bytes(encode_frame_bytes(_rich_buffer()))
        for cut in {1, 4, len(blob) // 4, len(blob) // 2, len(blob) - 1}:
            with pytest.raises(FrameError):
                decode_frame(blob[:cut])

    def test_garbage_rejected(self):
        with pytest.raises(FrameError):
            decode_frame(b"NNSB" + b"\x00" * 3)
        with pytest.raises(FrameError):
            decode_frame(b"XXXX" + b"\x00" * 64)

    def test_owning_helpers(self):
        raw = bytearray(b"abc")
        owned = owning_message(memoryview(raw))
        raw[0] = 0x7A
        assert owned == b"abc"
        b = b"already-bytes"
        assert owning_message(b) is b
        assert owning_tagged(b"D", memoryview(bytearray(b"xy"))) == b"Dxy"

    def test_gather_parts_matches_bytes_join(self):
        parts = encode_frame(_rich_buffer())
        assert bytes(gather_parts(parts)) == bytes(
            encode_frame_bytes(_rich_buffer()))


# ---------------------------------------------------------------------------
# torn frames at the socket layer — typed, never a hang
# ---------------------------------------------------------------------------

def _pair_sockets():
    a, b = socket.socketpair()
    b.settimeout(WAIT)
    return a, b


class TestTornFrames:
    def test_clean_eof_between_frames_is_none(self):
        a, b = _pair_sockets()
        try:
            send_msg(a, MsgType.EOS)
            a.close()
            assert recv_msg(b) == (MsgType.EOS, b"")
            assert recv_msg(b) is None
        finally:
            b.close()

    def test_torn_header_raises(self):
        a, b = _pair_sockets()
        try:
            a.sendall(b"NNSQ\x02")
            a.close()
            with pytest.raises(TornFrameError):
                recv_msg(b)
        finally:
            b.close()

    def test_torn_payload_raises(self):
        a, b = _pair_sockets()
        try:
            payload = bytes(encode_frame_bytes(_rich_buffer()))
            hdr = struct.pack("<4sBQ", b"NNSQ", int(MsgType.DATA),
                              len(payload))
            a.sendall(hdr + payload[: len(payload) // 2])
            a.close()
            with pytest.raises(TornFrameError):
                recv_msg(b)
        finally:
            b.close()

    def test_zero_byte_payload_eof_raises(self):
        a, b = _pair_sockets()
        try:
            a.sendall(struct.pack("<4sBQ", b"NNSQ", int(MsgType.DATA), 64))
            a.close()
            with pytest.raises(TornFrameError):
                recv_msg(b)
        finally:
            b.close()

    def test_server_survives_mid_frame_disconnect(self):
        srv = QueryServer().start()
        try:
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=5)
            send_msg(raw, MsgType.CAPABILITY, CAPS.encode())
            assert recv_msg(raw)[0] is MsgType.CAPABILITY
            raw.sendall(struct.pack("<4sBQ", b"NNSQ",
                                    int(MsgType.DATA), 4096) + b"x" * 10)
            raw.close()
            cli = QueryClient("127.0.0.1", srv.port)
            cli.connect(parse_caps_string(CAPS))
            cli.close()
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# negotiation matrix; echo servers of either package
# ---------------------------------------------------------------------------

def _echo_pump(srv, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            item = srv.inbox.get(timeout=0.05)
        except Exception:
            continue
        if isinstance(item, tuple):  # ("eos", cid)
            continue
        cid = item.meta.pop("client_id")
        idx = item.meta.pop("_qserve_idx", None)
        srv.send(cid, item, mark_idx=idx)


class _EchoServer:
    """A QueryServer of either package + a thread echoing its inbox."""

    def __init__(self, cls=QueryServer):
        self.cls = cls

    def __enter__(self):
        self.srv = self.cls().start()
        self._stop = threading.Event()
        self._t = threading.Thread(target=_echo_pump,
                                   args=(self.srv, self._stop), daemon=True)
        self._t.start()
        return self.srv

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        self.srv.stop()


def _roundtrip(cli, value: float = 2.0, buffer_cls=Buffer):
    buf = buffer_cls([np.full(8, value, np.float32)], meta={"tag": "t"})
    out = cli.request(buf, timeout=WAIT)
    assert out is not None and not isinstance(out, Exception)
    assert np.allclose(np.asarray(out.tensors[0]), value)
    return out


class TestNegotiation:
    def test_auto_negotiates_binary_and_shm_same_host(self):
        with _EchoServer() as srv:
            cli = QueryClient("127.0.0.1", srv.port)
            try:
                cli.connect(parse_caps_string(CAPS))
                assert cli.wire_format == transport.FORMAT_BINARY
                assert cli.shm_active
                assert _roundtrip(cli).meta.get("tag") == "t"
            finally:
                cli.close()

    def test_forced_json_stays_json(self):
        with _EchoServer() as srv:
            cli = QueryClient("127.0.0.1", srv.port, wire="json")
            try:
                cli.connect(parse_caps_string(CAPS))
                assert cli.wire_format == transport.FORMAT_JSON
                assert not cli.shm_active
                _roundtrip(cli, 5.0)
            finally:
                cli.close()

    def test_shm_opt_out_keeps_binary_wire(self):
        with _EchoServer() as srv:
            cli = QueryClient("127.0.0.1", srv.port, shm=False)
            try:
                cli.connect(parse_caps_string(CAPS))
                assert cli.wire_format == transport.FORMAT_BINARY
                assert not cli.shm_active
                _roundtrip(cli, 1.5)
            finally:
                cli.close()

    def test_legacy_server_falls_back_to_json(self):
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        lst.settimeout(WAIT)
        port = lst.getsockname()[1]

        def legacy():
            conn, _ = lst.accept()
            conn.settimeout(WAIT)
            with conn:
                while True:
                    try:
                        msg = recv_msg(conn)
                    except OSError:
                        return
                    if msg is None:
                        return
                    mtype, payload = msg
                    if mtype is MsgType.CAPABILITY:
                        send_msg(conn, MsgType.CAPABILITY,
                                 str(parse_caps_string(
                                     payload.decode())).encode())
                    elif mtype is MsgType.DATA:
                        send_msg(conn, MsgType.DATA,
                                 pack_tensors(unpack_tensors(payload)))

        t = threading.Thread(target=legacy, daemon=True)
        t.start()
        cli = QueryClient("127.0.0.1", port)
        try:
            cli.connect(parse_caps_string(CAPS))
            assert cli.wire_format == transport.FORMAT_JSON
            assert not cli.shm_active
            _roundtrip(cli, 4.0)
        finally:
            cli.close()
            lst.close()
            t.join(timeout=5)

    def test_offer_survives_legacy_caps_reserialization(self):
        offered = transport.offer_caps(
            CAPS, shm_host=transport.same_host_token())
        assert offered == R_transport.offer_caps(
            CAPS, shm_host=R_transport.same_host_token())
        caps, wire = transport.split_wire_caps(
            parse_caps_string(str(parse_caps_string(offered))))
        assert wire is not None
        assert transport.FORMAT_BINARY in transport.offered_formats(wire)
        assert "nns-wire" not in str(caps)


# ---------------------------------------------------------------------------
# a mixed fleet: the reference's client against the port's server and back
# ---------------------------------------------------------------------------

WIRES = {"json": dict(wire="json"), "binary": dict(shm=False),
         "shm": dict()}


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("direction", ["ref_client-port_server",
                                       "port_client-ref_server"])
def test_mixed_fleet(direction, wire):
    ref_client = direction.startswith("ref")
    server_cls = QueryServer if ref_client else RQueryServer
    client_cls = RQueryClient if ref_client else QueryClient
    caps = (r_parse_caps if ref_client else parse_caps_string)(CAPS)
    bcls = RBuffer if ref_client else Buffer
    with _EchoServer(server_cls) as srv:
        cli = client_cls("127.0.0.1", srv.port, **WIRES[wire])
        try:
            cli.connect(caps)
            want_fmt = "json" if wire == "json" else "binary"
            assert cli.wire_format == want_fmt
            assert cli.shm_active == (wire == "shm")
            rng = np.random.default_rng(5)
            for _ in range(3):
                a = rng.standard_normal((4, 8)).astype(np.float32)
                out = cli.request(bcls([a], pts=0.25, meta={"k": [1, "x"]}),
                                  timeout=WAIT)
                assert np.asarray(out.tensors[0]).tobytes() == a.tobytes()
                assert out.meta.get("k") == [1, "x"]
        finally:
            cli.close()


# ---------------------------------------------------------------------------
# shm ring lifecycle
# ---------------------------------------------------------------------------

class TestShmRing:
    def test_roundtrip_and_slot_release(self):
        ring = transport.create_ring(slots=2)  # pairs-with: detach_ring
        try:
            buf = _rich_buffer()
            desc = ring.write_frame(encode_frame(buf))
            assert desc is not None and transport.is_shm_descriptor(desc)
            name, slot, gen, nbytes = transport.unpack_descriptor(desc)
            assert name == ring.name
            assert ring.in_flight() == 1
            out = ring.read_frame(slot, gen, nbytes)
            assert ring.in_flight() == 0
            for a, b in zip(buf.tensors, out.tensors):
                assert np.ascontiguousarray(a).tobytes() == b.tobytes()
            assert out.meta == buf.meta
        finally:
            transport.detach_ring(ring)

    def test_bfloat16_slot_is_copied_out(self):
        """A slot is recycled after release: the decoded bfloat16 tensor
        must own its bytes."""
        ring = transport.create_ring(slots=1)  # pairs-with: detach_ring
        try:
            t = torch.tensor([0.5, 1.5, -2.0], dtype=torch.bfloat16)
            desc = ring.write_frame(encode_frame(Buffer([t])))
            out = ring.read_frame(*transport.unpack_descriptor(desc)[1:])
            ring.write_frame(encode_frame(Buffer(
                [torch.zeros(3, dtype=torch.bfloat16)])))
            assert out.tensors[0].tolist() == [0.5, 1.5, -2.0]
        finally:
            transport.detach_ring(ring)

    def test_full_ring_returns_none_for_inline_fallback(self):
        ring = transport.create_ring(slots=1)  # pairs-with: detach_ring
        try:
            parts = encode_frame(Buffer([np.zeros(4, np.float32)]))
            assert ring.write_frame(parts) is not None
            assert ring.write_frame(parts) is None
        finally:
            transport.detach_ring(ring)

    def test_oversize_frame_returns_none(self):
        ring = transport.create_ring(slot_bytes=256)  # pairs-with: detach_ring
        try:
            parts = encode_frame(Buffer([np.zeros(1024, np.float32)]))
            assert ring.write_frame(parts) is None
        finally:
            transport.detach_ring(ring)

    def test_reclaim_invalidates_outstanding_descriptors(self):
        ring = transport.create_ring(slots=2)  # pairs-with: detach_ring
        try:
            desc = ring.write_frame(
                encode_frame(Buffer([np.arange(8).astype(np.float32)])))
            _name, slot, gen, nbytes = transport.unpack_descriptor(desc)
            assert ring.reclaim() == 1
            assert ring.in_flight() == 0
            with pytest.raises(FrameError):
                ring.read_frame(slot, gen, nbytes)
            assert ring.write_frame(
                encode_frame(Buffer([np.zeros(2, np.float32)]))) is not None
        finally:
            transport.detach_ring(ring)

    def test_close_unlinks_segment(self):
        ring = transport.create_ring()  # pairs-with: detach_ring
        seg = pathlib.Path("/dev/shm") / ring.name
        assert seg.exists()
        transport.detach_ring(ring)
        assert not seg.exists()
        transport.detach_ring(ring)

    def test_attach_sees_writer_frames(self):
        ring = transport.create_ring()  # pairs-with: detach_ring
        reader = None
        try:
            reader = transport.attach_ring(ring.name)  # pairs-with: detach_ring
            buf = Buffer([np.arange(6).astype(np.int32)], meta={"n": 1})
            desc = ring.write_frame(encode_frame(buf))
            _n, slot, gen, nbytes = transport.unpack_descriptor(desc)
            out = reader.read_frame(slot, gen, nbytes)
            assert out.tensors[0].tobytes() == buf.tensors[0].tobytes()
            assert ring.in_flight() == 0
        finally:
            transport.detach_ring(reader)
            transport.detach_ring(ring)

    def test_descriptor_sniffs_distinctly(self):
        desc = transport.pack_descriptor("nns-x", 0, 1, 64)
        assert transport.is_shm_descriptor(desc)
        assert not is_binary_frame(desc)
        assert not transport.is_shm_descriptor(
            encode_frame_bytes(Buffer([np.zeros(1, np.float32)])))


# ---------------------------------------------------------------------------
# byte parity binary vs JSON vs shm across the port's fusion parity lines
# ---------------------------------------------------------------------------

def _fusion_lines():
    from test_torch_fusion import PARITY_LINES
    return PARITY_LINES


def _capture_buffers(line):
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(line.format(fw="torch", acc="accelerator=cpu "),
                        fuse=True)
    grabbed = []
    for el in pipe.sinks:
        def render(buf, _el=el):
            grabbed.append(buf.as_numpy())
            type(_el).render(_el, buf)
        el.render = render
    pipe.run(timeout=40.0)
    return grabbed


def _tensor_sig(buf):
    return tuple((DataType.from_any(t.dtype).value, tuple(t.shape),
                  _bytes_of(t)) for t in buf.tensors)


@pytest.mark.parametrize("name", sorted(_fusion_lines()))
def test_wire_parity_across_fusion_pipelines(name):
    bufs = _capture_buffers(_fusion_lines()[name])
    assert bufs, f"{name}: pipeline produced no buffers"
    ring = transport.create_ring(  # pairs-with: detach_ring
        slot_bytes=max(1 << 20, max(b.nbytes for b in bufs) + 4096))
    try:
        for buf in bufs:
            want = _tensor_sig(buf)
            via_json = unpack_tensors(pack_tensors(buf))
            assert _tensor_sig(via_json) == want, f"{name}: json parity"
            via_bin = decode_frame(encode_frame_bytes(buf))
            assert _tensor_sig(via_bin) == want, f"{name}: binary parity"
            assert via_bin.meta == via_json.meta
            assert via_bin.pts == via_json.pts
            desc = ring.write_frame(encode_frame(buf))
            assert desc is not None
            via_shm = ring.read_frame(*transport.unpack_descriptor(desc)[1:])
            assert _tensor_sig(via_shm) == want, f"{name}: shm parity"
            assert via_shm.meta == via_bin.meta
    finally:
        transport.detach_ring(ring)


# ---------------------------------------------------------------------------
# XFERCHECK: the shm path moves only descriptor bytes over the socket
# ---------------------------------------------------------------------------

class TestXfercheckLedger:
    @pytest.fixture(autouse=True)
    def _armed(self):
        was = sanitizer.xfercheck_enabled()
        sanitizer.enable_xfercheck()
        sanitizer.reset_xfercheck()
        try:
            yield
        finally:
            sanitizer.reset_xfercheck()
            if not was:
                sanitizer.disable_xfercheck()

    @staticmethod
    def _stage_bytes():
        return {(r["stage"], r["direction"]): r["bytes"]
                for r in sanitizer.xfer_transfers()}

    def test_shm_request_sends_descriptors_not_payload(self):
        payload = np.zeros(64 * 1024, np.float32)
        with _EchoServer() as srv:
            cli = QueryClient("127.0.0.1", srv.port)
            try:
                cli.connect(parse_caps_string(CAPS))
                assert cli.shm_active
                sanitizer.reset_xfercheck()
                out = cli.request(Buffer([payload]), timeout=WAIT)
                assert np.asarray(out.tensors[0]).nbytes == payload.nbytes
            finally:
                cli.close()
        rows = self._stage_bytes()
        wire = rows.get(("wire:socket", "host"), 0)
        assert rows.get(("shm:write", "host"), 0) >= 2 * payload.nbytes
        assert 0 < wire < payload.nbytes // 4, rows

    def test_json_wire_pays_full_payload_on_socket(self):
        payload = np.zeros(16 * 1024, np.float32)
        with _EchoServer() as srv:
            cli = QueryClient("127.0.0.1", srv.port, wire="json")
            try:
                cli.connect(parse_caps_string(CAPS))
                sanitizer.reset_xfercheck()
                cli.request(Buffer([payload]), timeout=WAIT)
            finally:
                cli.close()
        rows = self._stage_bytes()
        assert rows.get(("wire:socket", "host"), 0) >= 2 * payload.nbytes
        assert ("shm:write", "host") not in rows


def test_wirefuzz_scorekeeper_matches_the_reference():
    """The port's scorekeeper gives the reference's report for the same
    events (frames counted at the codec choke point while armed)."""
    from nnstreamer_tpu.analysis import sanitizer as rsan

    blob = bytes(encode_frame_bytes(_rich_buffer()))
    reports = []
    for san, dec in ((sanitizer, decode_frame),
                     (rsan, R_transport.decode_frame)):
        was = san.wirefuzz_enabled()
        san.enable_wirefuzz()
        try:
            dec(blob)
            san.note_mutant("decode_frame", "truncate", "typed")
            san.note_mutant("decode_frame", "flip", "clean")
            reports.append(san.wirefuzz_report())
        finally:
            san.reset_wirefuzz()
            if not was:
                san.disable_wirefuzz()
    assert reports[0] == reports[1]
    assert reports[0]["frames"]["wire:decode"]["bytes"] == len(blob)
