"""The port's wire fuzzer (tools/wirefuzz_torch.py) and its scorekeeper
(nnstreamer_tpu_torch.analysis.sanitizer, fourth half), mirroring
tests/test_wirefuzz.py test by test, each held against the reference.

Both tools build their catalogs from the same seed over byte-equal
frames, so the port's catalog must equal the reference's mutant by
mutant (family, name and bytes), and each offline mutant must meet the
same fate in both packages. The version-skew cells run every pairing of
a client and a server of either package. The full catalog's scoreboard
equals the reference's recorded run (WIREFUZZ_r19.json) surface by
surface."""
import json
import random
import socket
import struct
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from nnstreamer_tpu_torch import transport
from nnstreamer_tpu_torch.analysis import sanitizer
from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.core.serialize import pack_tensors, unpack_tensors
from nnstreamer_tpu_torch.query.protocol import MsgType, recv_msg, send_msg
from nnstreamer_tpu_torch.query.server import QueryServer
from nnstreamer_tpu_torch.transport.frame import FrameError

from torch_mirror import mod

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import wirefuzz  # noqa: E402  (the reference's tool)
import wirefuzz_torch  # noqa: E402

CAPS = "other/tensors,format=static,dimensions=8,types=float32"
TOOLS = {"ref": wirefuzz, "port": wirefuzz_torch}


def _san(side):
    return mod(side, "analysis.sanitizer")


@pytest.fixture
def armed():
    """Arm both packages' fuzz scorekeepers (the port's is the one under
    test; the reference's runs the same calls for comparison)."""
    was = {side: _san(side).wirefuzz_enabled() for side in TOOLS}
    for side in TOOLS:
        _san(side).enable_wirefuzz()
    yield
    for side in TOOLS:
        if was[side]:
            _san(side).reset_wirefuzz()
        else:
            _san(side).disable_wirefuzz()


def _same_report(fn):
    """Run ``fn(sanitizer)`` against both scorekeepers; return the port's
    report after checking it equals the reference's (``enabled`` and the
    violation rows' thread names aside)."""
    reps = {}
    for side in TOOLS:
        fn(_san(side))
        rep = _san(side).wirefuzz_report()
        rep["violations"] = [{k: v for k, v in row.items() if k != "thread"}
                             for row in rep["violations"]]
        reps[side] = rep
    assert reps["port"] == reps["ref"]
    return reps["port"]


# ---------------------------------------------------------------------------
# scorekeeper ledger units
# ---------------------------------------------------------------------------

class TestWirefuzzLedger:
    def test_typed_and_clean_outcomes_are_not_violations(self, armed):
        def run(san):
            san.note_mutant("s", "m1", "typed", "FrameError: x")
            san.note_mutant("s", "m2", "clean")
        rep = _same_report(run)
        assert sanitizer.wirefuzz_violations() == []
        assert rep["mutants_total"] == 2
        assert rep["typed"] == 1 and rep["clean"] == 1

    @pytest.mark.wirefuzz_ok
    def test_hang_crash_silent_record_violations(self, armed):
        def run(san):
            san.note_mutant("s", "m1", "hang", "6.0s > 5.0s")
            san.note_mutant("s", "m2", "crash", "KeyError: boom")
            san.note_mutant("s", "m3", "silent", "parity failed")
        rep = _same_report(run)
        rows = sanitizer.wirefuzz_violations()
        assert [r["outcome"] for r in rows] == ["hang", "crash", "silent"]
        assert rep["hangs"] == 1 and rep["crashes"] == 1
        assert rep["silent"] == 1
        assert len(rep["violations"]) == 3

    def test_per_surface_breakdown(self, armed):
        def run(san):
            san.note_mutant("decode_frame", "a", "typed")
            san.note_mutant("decode_frame", "b", "typed")
            san.note_mutant("shm_ring", "c", "clean")
        surfaces = _same_report(run)["surfaces"]
        assert surfaces["decode_frame"]["typed"] == 2
        assert surfaces["shm_ring"]["clean"] == 1

    def test_frame_events_counted(self, armed):
        def run(san):
            san.note_frame_event("stage_x", 128)
            san.note_frame_event("stage_x", 64)
        frames = _same_report(run)["frames"]
        assert frames["stage_x"] == {"frames": 2, "bytes": 192}

    def test_codec_choke_points_feed_the_ledger(self, armed):
        def counts(side):
            frames = _san(side).wirefuzz_report()["frames"]
            return tuple(frames.get(stage, {}).get("frames", 0)
                         for stage in ("wire:encode", "wire:decode"))

        seen = {}
        for side in TOOLS:
            tr = mod(side, "transport")
            before = counts(side)
            buf = mod(side, "core").Buffer([np.zeros((2, 2), np.float32)])
            tr.decode_frame(bytes(tr.encode_frame_bytes(buf)))
            seen[side] = tuple(a - b for a, b in zip(counts(side), before))
        assert seen["port"][0] > 0 and seen["port"][1] > 0
        assert seen["port"] == seen["ref"]

    def test_disabled_fast_path_records_nothing(self):
        was = sanitizer.wirefuzz_enabled()
        sanitizer.disable_wirefuzz()
        try:
            sanitizer.note_mutant("ghost", "m", "crash", "never seen")
            sanitizer.note_frame_event("ghost", 1)
            assert sanitizer.wirefuzz_violations() == []
            assert sanitizer.wirefuzz_report()["mutants_total"] == 0
        finally:
            if was:
                sanitizer.enable_wirefuzz()

    @pytest.mark.wirefuzz_ok
    def test_reset_clears_the_scoreboard(self, armed):
        def run(san):
            san.note_mutant("s", "m", "crash", "x")
            san.reset_wirefuzz()
        _same_report(run)
        assert sanitizer.wirefuzz_violations() == []
        assert sanitizer.wirefuzz_report()["mutants_total"] == 0


# ---------------------------------------------------------------------------
# mutation catalog: deterministic, structure-aware, broad — and the
# reference's, mutant by mutant
# ---------------------------------------------------------------------------

def _nnsb_blob(seed=19, json_safe=False, side="port"):
    rng = random.Random(seed)
    buf = TOOLS[side]._baseline_buffers(rng, json_safe=json_safe)[0][1]
    return bytes(mod(side, "transport").encode_frame_bytes(buf))


class TestMutationCatalog:
    def test_nnsb_catalog_is_deterministic(self):
        blob = _nnsb_blob()
        a = list(wirefuzz_torch.nnsb_mutants(blob, random.Random(19)))
        b = list(wirefuzz_torch.nnsb_mutants(blob, random.Random(19)))
        assert a == b
        assert len(a) >= 60

    def test_nnst_catalog_is_deterministic(self):
        rng = random.Random(19)
        buf = wirefuzz_torch._baseline_buffers(rng, json_safe=True)[0][1]
        blob = bytes(pack_tensors(buf))
        a = list(wirefuzz_torch.nnst_mutants(blob, random.Random(7)))
        b = list(wirefuzz_torch.nnst_mutants(blob, random.Random(7)))
        assert a == b
        assert len(a) >= 15

    def test_catalog_covers_every_mutation_family(self):
        names = [m for m, _ in wirefuzz_torch.nnsb_mutants(
            _nnsb_blob(), random.Random(19))]
        for family in ("truncate@", "bitflip:magic", "bitflip:payload",
                       "ntensors=", "metalen=", "version=", "magic=NNST",
                       "t0:dtype", "t0:rank", "t0:nbytes", "t0:dim0",
                       "meta:count=max", "meta:badtag"):
            assert any(n.startswith(family) for n in names), family

    def test_every_offline_mutant_is_typed_or_parity_clean(self):
        blob = _nnsb_blob()
        transport.decode_frame(blob)
        for mutation, mutant in wirefuzz_torch.nnsb_mutants(
                blob, random.Random(19)):
            try:
                out = transport.decode_frame(mutant)
            except ValueError:
                continue  # typed: FrameError is a ValueError
            # survivors must re-encode/re-decode to the same buffer
            rt = transport.decode_frame(
                bytes(transport.encode_frame_bytes(out)))
            assert wirefuzz_torch._buffers_equal(out, rt), mutation

    def test_trailing_bytes_regression(self):
        """A zeroed tensor count must not decode 'successfully' while
        ignoring every payload byte: the frame accounts for all of its
        bytes (transport/frame.py full-consumption check)."""
        blob = bytearray(_nnsb_blob())
        struct.pack_into("<I", blob, 8, 0)  # ntensors = 0
        with pytest.raises(FrameError, match="trailing bytes"):
            transport.decode_frame(bytes(blob))


def _catalog(side, codec, tag):
    """``side``'s seed-19 catalog over its ``tag`` baseline in ``codec``
    (NNSB over the sidecar-meta baselines, NNST over the JSON-safe
    ones), as the decode surface builds it."""
    tool = TOOLS[side]
    rng = random.Random(19)
    buf = dict(tool._baseline_buffers(rng, json_safe=codec == "nnst"))[tag]
    if codec == "nnsb":
        blob = bytes(mod(side, "transport").encode_frame_bytes(buf))
        return blob, list(tool.nnsb_mutants(blob, rng))
    blob = bytes(mod(side, "core.serialize").pack_tensors(buf))
    return blob, list(tool.nnst_mutants(blob, rng))


@pytest.mark.parametrize("codec", ["nnsb", "nnst"])
@pytest.mark.parametrize("tag", ["dense", "sparse"])
def test_catalog_equals_the_reference_mutant_by_mutant(codec, tag):
    ref_blob, ref = _catalog("ref", codec, tag)
    port_blob, port = _catalog("port", codec, tag)
    assert port_blob == ref_blob
    assert [m for m, _ in port] == [m for m, _ in ref]
    for (name, a), (_, b) in zip(port, ref):
        assert a == b, name
    assert len(port) >= 15


def _fates(side, monkeypatch, run):
    """Every (surface, mutation, outcome) that ``run(tool)`` records."""
    san = _san(side)
    rows = []
    orig = san.note_mutant

    def note(surface, mutation, outcome, detail=""):
        rows.append((surface, mutation, outcome))
        orig(surface, mutation, outcome, detail)
    monkeypatch.setattr(san, "note_mutant", note)
    try:
        run(TOOLS[side])
    finally:
        monkeypatch.setattr(san, "note_mutant", orig)
    return rows


@pytest.mark.parametrize("surface", ["decode", "shm"])
def test_offline_outcomes_equal_the_reference(surface, armed, monkeypatch):
    """The full seed-19 catalog on the offline surfaces: each mutant is
    typed or clean in the port exactly where it is in the reference."""
    def run(tool):
        rng = random.Random(19)
        if surface == "decode":
            tool.run_decode_surface(rng, smoke=False)
        else:
            tool.run_shm_surface(rng)
    ref = _fates("ref", monkeypatch, run)
    port = _fates("port", monkeypatch, run)
    assert port == ref
    assert {o for _, _, o in port} <= {"typed", "clean"}
    assert len(port) >= (140 if surface == "decode" else 15)


def test_cpu_tensor_baselines_score_as_host_arrays(armed):
    """Baselines held as torch tensors (the encoder's pull path, here
    from the CPU) give the host arrays' scoreboard, surface by surface."""
    boards = []
    for device in (None, "cpu"):
        sanitizer.reset_wirefuzz()
        rng = random.Random(19)
        wirefuzz_torch.run_decode_surface(rng, False, device)
        wirefuzz_torch.run_shm_surface(rng, device)
        boards.append(sanitizer.wirefuzz_report()["surfaces"])
    assert boards[0] == boards[1]
    assert sanitizer.wirefuzz_violations() == []


# ---------------------------------------------------------------------------
# surfaces end-to-end (smoke-scale): zero contract violations
# ---------------------------------------------------------------------------

class TestSurfaces:
    def test_decode_surface_smoke(self, armed):
        before = sanitizer.wirefuzz_report()["mutants_total"]
        wirefuzz_torch.run_decode_surface(random.Random(19), smoke=True)
        rep = sanitizer.wirefuzz_report()
        assert rep["mutants_total"] - before >= 60
        assert sanitizer.wirefuzz_violations() == []

    def test_shm_surface(self, armed):
        wirefuzz_torch.run_shm_surface(random.Random(19))
        rep = sanitizer.wirefuzz_report()
        assert rep["surfaces"]["shm_ring"]["typed"] >= 10
        assert sanitizer.wirefuzz_violations() == []

    def test_live_server_surface_smoke(self, armed):
        wirefuzz_torch.run_live_surface(random.Random(19), smoke=True)
        rep = sanitizer.wirefuzz_report()
        per = rep["surfaces"]["query_server"]
        assert sum(per.values()) >= 5
        assert sanitizer.wirefuzz_violations() == []


# ---------------------------------------------------------------------------
# negotiation version-skew cells, over every client/server pairing of the
# two packages
# ---------------------------------------------------------------------------

PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]


def _echo_pump(srv, stop):
    while not stop.is_set():
        try:
            item = srv.inbox.get(timeout=0.05)
        except Exception:
            continue
        if isinstance(item, tuple):
            continue
        cid = item.meta.pop("client_id")
        idx = item.meta.pop("_qserve_idx", None)
        srv.send(cid, item, mark_idx=idx)


class _EchoServer:
    def __init__(self, side="port"):
        self.side = side

    def __enter__(self):
        self.srv = mod(self.side, "query.server").QueryServer().start()
        self._stop = threading.Event()
        self._t = threading.Thread(target=_echo_pump,
                                   args=(self.srv, self._stop), daemon=True)
        self._t.start()
        return self.srv

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        self.srv.stop()


def _proto(side):
    return mod(side, "query.protocol")


class TestVersionSkew:
    @pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
    def test_old_client_new_server_stays_json(self, client, server):
        """A pre-NNSB client offers PLAIN caps (no nns-wire structure);
        the server must reply with caps the old parser understands and
        answer in NNST — never binary frames the old peer cannot
        decode."""
        p = _proto(client)
        with _EchoServer(server) as srv:
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5.0)
            s.settimeout(5.0)
            try:
                p.send_msg(s, p.MsgType.CAPABILITY, CAPS.encode())
                msg = p.recv_msg(s)
                assert msg is not None and msg[0] is p.MsgType.CAPABILITY
                reply = msg[1].decode()
                assert "nns-wire" not in reply and "selected" not in reply
                ser = mod(client, "core.serialize")
                buf = mod(client, "core").Buffer(
                    [np.full(8, 3.0, np.float32)])
                send = bytes(ser.pack_tensors(buf))
                p.send_msg(s, p.MsgType.DATA, send)
                msg = p.recv_msg(s)
                assert msg is not None and msg[0] is p.MsgType.DATA
                assert not mod(client, "transport").is_binary_frame(msg[1])
                out = ser.unpack_tensors(msg[1])
                assert np.allclose(np.asarray(out.tensors[0]), 3.0)
                # the port's NNST bytes are the reference's
                assert bytes(pack_tensors(unpack_tensors(msg[1]))) == \
                    bytes(mod("ref", "core.serialize").pack_tensors(
                        mod("ref", "core.serialize").unpack_tensors(msg[1])))
            finally:
                s.close()

    @pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
    def test_garbage_caps_token_is_typed_not_fatal(self, client, server):
        """Undecodable capability bytes must produce a typed ERROR or a
        drop on THAT link; the server keeps serving the next client."""
        p = _proto(client)
        with _EchoServer(server) as srv:
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5.0)
            s.settimeout(5.0)
            try:
                p.send_msg(s, p.MsgType.CAPABILITY, b"\xff\xfe\x00garbage")
                msg = p.recv_msg(s)
                assert msg is None or msg[0] is p.MsgType.ERROR
            except ConnectionError:
                pass  # typed drop is equally acceptable
            finally:
                s.close()
            # the server survived: a well-formed client still negotiates
            s2 = socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=5.0)
            s2.settimeout(5.0)
            try:
                p.send_msg(s2, p.MsgType.CAPABILITY, CAPS.encode())
                msg = p.recv_msg(s2)
                assert msg is not None and msg[0] is p.MsgType.CAPABILITY
            finally:
                s2.close()

    @pytest.mark.parametrize("client,server", PAIRS, ids=PAIR_IDS)
    def test_unknown_msg_type_is_typed_connection_error(self, client,
                                                        server):
        """A frame with an unknown NNSQ message type must surface as the
        torn-frame family on the reading side, not a raw ValueError from
        the enum constructor."""
        p = _proto(client)
        with _EchoServer(server) as srv:
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5.0)
            s.settimeout(5.0)
            try:
                p.send_msg(s, p.MsgType.CAPABILITY, CAPS.encode())
                msg = p.recv_msg(s)
                assert msg is not None
                hdr = struct.Struct("<4sBQ")
                s.sendall(hdr.pack(b"NNSQ", 99, 4) + b"\x00" * 4)
                # server drops the link: EOF or reset on our next read
                try:
                    assert p.recv_msg(s) is None
                except ConnectionError:
                    pass
            finally:
                s.close()


# ---------------------------------------------------------------------------
# harness entrypoint
# ---------------------------------------------------------------------------

_RECORD = ROOT / "WIREFUZZ_r19.json"


class TestHarness:
    def test_smoke_run_passes_and_records(self, tmp_path, armed):
        out = tmp_path / "wf.json"
        assert wirefuzz_torch.main(["--smoke", "--seed", "19",
                                    "--device", "cpu",
                                    "--json", str(out)]) == 0
        report = json.loads(out.read_text())
        assert report["verdict"] == "PASS"
        assert report["mutants_total"] > 0
        assert report["violations"] == []
        assert report["seed"] == 19

    def test_recorded_full_run_scoreboard(self):
        """WIREFUZZ_r19.json is the reference's committed full-catalog
        run, the port's target: keep it honest (PASS, all three
        surfaces, zero violations)."""
        report = json.loads(_RECORD.read_text())
        assert report["verdict"] == "PASS"
        assert report["violations"] == []
        assert report["typed"] + report["clean"] == report["mutants_total"]
        for surface in ("decode_frame", "unpack_tensors", "shm_ring",
                        "query_server"):
            assert surface in report["surfaces"], surface


def test_full_run_equals_the_recorded_scoreboard(tmp_path, armed):
    """The full catalog through the port (CPU tensors): 0 hangs, crashes
    and silent decodes, and per-surface typed/clean counts equal to the
    reference's recorded run."""
    out = tmp_path / "full.json"
    assert wirefuzz_torch.main(["--seed", "19", "--device", "cpu",
                                "--json", str(out)]) == 0
    port = json.loads(out.read_text())
    ref = json.loads(_RECORD.read_text())
    assert (port["hangs"], port["crashes"], port["silent"]) == (0, 0, 0)
    assert port["surfaces"] == ref["surfaces"]
    assert port["mutants_total"] == ref["mutants_total"] == 227


# ---------------------------------------------------------------------------
# a static server holds every inbound frame to its caps (ROADMAP §C, R1)
# ---------------------------------------------------------------------------

MB_CAPS = "other/tensors,format=static,dimensions=3:224:224:1,types=float32"


def _decode_any(payload):
    """An answer of either codec (a plain-caps client gets NNST)."""
    return (transport.decode_frame(payload)
            if transport.is_binary_frame(payload) else unpack_tensors(payload))


def test_static_server_drops_a_clean_decode_off_its_caps():
    """The seed-19 catalog's ``t0:tflags=65535`` mutant of a real
    (1, 224, 224, 3) frame decodes clean as an empty sparse frame. A
    MobileNet-v2 server line used to push it into its filter, whose
    TypeError stopped the server: every later request hung. The server
    now drops that link (typed) and keeps serving: the payload-flip
    mutant and a clean frame still get 1001 logits."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    frame = np.random.default_rng(19).uniform(
        -1, 1, (1, 224, 224, 3)).astype(np.float32)
    blob = bytes(transport.encode_frame_bytes(Buffer([frame])))
    catalog = dict(wirefuzz_torch.nnsb_mutants(blob, random.Random(19)))
    server = parse_launch(
        "tensor_query_serversrc name=ssrc id=210 port=0 "
        f"caps={MB_CAPS} ! tensor_filter framework=torch accelerator=cpu "
        "model=nnstreamer_tpu_torch.models.mobilenet_v2:filter_model "
        "! tensor_query_serversink id=210")
    server.play()
    try:
        port = server.get("ssrc").bound_port

        def poke(payload):
            s = socket.create_connection(("127.0.0.1", port), timeout=30.0)
            s.settimeout(30.0)
            try:
                send_msg(s, MsgType.CAPABILITY, MB_CAPS.encode())
                assert recv_msg(s)[0] is MsgType.CAPABILITY
                send_msg(s, MsgType.DATA, payload)
                return recv_msg(s)
            finally:
                s.close()

        sparse = transport.decode_frame(catalog["t0:tflags=65535"])
        assert "sparse_specs" in sparse.meta   # it does decode clean
        assert poke(catalog["t0:tflags=65535"]) is None   # dropped, typed
        for payload in (catalog["bitflip:payload"], blob):
            msg = poke(payload)
            assert msg is not None and msg[0] is MsgType.DATA
            out = _decode_any(msg[1])
            assert tuple(out.tensors[0].shape)[-1] == 1001
    finally:
        server.stop()


@pytest.mark.parametrize("mutation", ["t0:tflags=65535", "one-element"])
def test_static_server_refuses_another_layout(mutation):
    """The same gate at the scaler's (8,) float32 caps: a sparse decode
    and a frame of another element count are dropped, typed, before the
    filter; the next clean frame is answered."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    good = Buffer([np.arange(8, dtype=np.float32)])
    blob = bytes(transport.encode_frame_bytes(good))
    if mutation == "one-element":   # a coherent frame of 1 element
        bad = bytes(transport.encode_frame_bytes(
            Buffer([np.ones(1, np.float32)])))
    else:
        bad = dict(wirefuzz_torch.nnsb_mutants(
            blob, random.Random(19)))[mutation]
    server = parse_launch(
        f"tensor_query_serversrc name=ssrc id=211 port=0 caps={CAPS} "
        "! tensor_filter framework=torch accelerator=cpu "
        "model=builtin://scaler?factor=2 ! tensor_query_serversink id=211")
    server.play()
    try:
        port = server.get("ssrc").bound_port
        answers = []
        for payload in (bad, blob):
            s = socket.create_connection(("127.0.0.1", port), timeout=10.0)
            s.settimeout(10.0)
            try:
                send_msg(s, MsgType.CAPABILITY, CAPS.encode())
                assert recv_msg(s)[0] is MsgType.CAPABILITY
                send_msg(s, MsgType.DATA, payload)
                answers.append(recv_msg(s))
            finally:
                s.close()
        assert answers[0] is None
        out = _decode_any(answers[1][1])
        np.testing.assert_array_equal(np.asarray(out.tensors[0]),
                                      np.arange(8, dtype=np.float32) * 2)
    finally:
        server.stop()
