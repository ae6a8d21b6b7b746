"""The port's stream sharding (``elements/shard.py``, the placement
planner's ``_shard_weights``) and gRPC bridge (``query/grpc_io.py``, with
the IDL codecs it carries) against nnstreamer_tpu's.

* the cases of the reference's ``tests/test_shard.py`` (round robin, the
  ordered re-join under latency skew, a gap declared lost, sharding across
  two query workers) on the port, and weighted dispatch sending the same
  frames to the same branches as the reference;
* the planner's branch weights from one profile, equal to the reference
  planner's, applied to the element;
* the cases of ``tests/test_grpc.py`` (push, pull, caps, an offloaded
  sub-graph) on the port, a reference ``tensor_sink_grpc`` feeding a port
  ``tensor_src_grpc`` (and back), byte for byte;
* with ``grpc`` absent, both grpc elements post a bus ERROR naming grpc
  (``FrameworkUnavailable``) and nothing reaches the sink;
* the cases of ``tests/test_wire_formats.py`` on the port's protobuf and
  flatbuf codecs.

Every wait is bounded."""
import sys
import time

import numpy as np
import pytest

pytest.importorskip("grpc")

from nnstreamer_tpu.runtime.parse import parse_launch as r_parse_launch  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer, MessageType, TensorFormat  # noqa: E402
from nnstreamer_tpu_torch.core import wire_flatbuf, wire_protobuf  # noqa: E402
from nnstreamer_tpu_torch.runtime.parse import parse_launch  # noqa: E402

CAPS = "other/tensors,format=static,dimensions=4,types=float32"


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert cond()


def _vals(out):
    return [float(np.asarray(b.as_numpy().tensors[0]).reshape(-1)[0])
            for b in out]


def _collect(pipe, name="out", n=None, timeout=20.0):
    out = []
    pipe.get(name).connect(out.append)
    pipe.play()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if n is not None and len(out) >= n:
            break
        try:
            pipe.wait(timeout=0.1)
            break
        except TimeoutError:
            continue
    pipe.stop()
    return out


# ---------------------------------------------------------------------------
# tensor_shard / tensor_unshard (reference tests/test_shard.py)
# ---------------------------------------------------------------------------

class TestShardLocal:
    def test_round_robin_exclusive(self):
        pipe = parse_launch(
            "tensor_src num-buffers=6 dimensions=1 types=float32 "
            "pattern=counter ! tensor_shard name=s "
            "s.src_0 ! tensor_sink name=a max-stored=16 "
            "s.src_1 ! tensor_sink name=b max-stored=16")
        a, b = [], []
        pipe.get("a").connect(a.append)
        pipe.get("b").connect(b.append)
        pipe.play()
        pipe.wait(timeout=20)
        pipe.stop()
        assert _vals(a) == [0, 2, 4] and _vals(b) == [1, 3, 5]
        assert [x.meta["shard_seq"] for x in a] == [0, 2, 4]

    def test_rejoin_restores_order_with_latency_skew(self):
        from nnstreamer_tpu_torch.backends.custom_easy import \
            register_custom_easy

        def slow(inputs):
            time.sleep(0.05)
            return [np.asarray(x) for x in inputs]

        try:
            register_custom_easy("shard_slow_port", slow)
        except ValueError:
            pass
        pipe = parse_launch(
            "tensor_src num-buffers=8 dimensions=1 types=float32 "
            "pattern=counter ! tensor_shard name=s "
            "s.src_0 ! queue ! tensor_filter framework=custom-easy "
            "model=shard_slow_port ! u.sink_0 s.src_1 ! queue ! u.sink_1 "
            "tensor_unshard name=u ! tensor_sink name=out max-stored=32")
        assert _vals(_collect(pipe, n=8)) == [0, 1, 2, 3, 4, 5, 6, 7]

    def test_gap_declared_lost_when_buffer_full(self):
        pipe = parse_launch(
            "tensor_src num-buffers=8 dimensions=1 types=float32 "
            "pattern=counter ! tensor_shard name=s "
            "s.src_0 ! queue ! tensor_if compared-value=a-value "
            "compared-value-option=0:0 operator=lt supplied-value=-1 "
            "then=passthrough else=skip ! u.sink_0 s.src_1 ! queue ! u.sink_1 "
            "tensor_unshard name=u max-buffered=2 ! tensor_sink name=out "
            "max-stored=32")
        assert _vals(_collect(pipe, n=4)) == [1, 3, 5, 7]


SHARD3 = ("tensor_src num-buffers=12 dimensions=1 types=float32 "
          "pattern=counter ! tensor_shard name=s weights=0.5,0.25,0.25 "
          "s.src_0 ! tensor_sink name=a max-stored=32 "
          "s.src_1 ! tensor_sink name=b max-stored=32 "
          "s.src_2 ! tensor_sink name=c max-stored=32")


def test_weighted_dispatch_equals_the_reference():
    got = {}
    for pkg, parse in (("port", parse_launch), ("ref", r_parse_launch)):
        pipe = parse(SHARD3)
        outs = {k: [] for k in "abc"}
        for k in "abc":
            pipe.get(k).connect(outs[k].append)
        pipe.play()
        pipe.wait(timeout=20)
        pipe.stop()
        got[pkg] = {k: _vals(v) for k, v in outs.items()}
    assert got["port"] == got["ref"]
    assert len(got["port"]["a"]) == 6


class _Digest:
    def __init__(self, ms):
        self.ms = ms

    def quantile(self, q):
        return self.ms / 1e3


class _Artifact:
    def __init__(self, costs):
        self.entries = {"element": {
            k: {"count": 10, "digest": _Digest(v)} for k, v in costs.items()}}


SHARD_PLACE = ("tensor_src num-buffers=4 dimensions=1 types=float32 "
               "pattern=counter ! tensor_shard name=s "
               "s.src_0 ! queue name=q0 ! tensor_sink name=a "
               "s.src_1 ! queue name=q1 ! tensor_sink name=b "
               "s.src_2 ! queue name=q2 ! tensor_sink name=c")


def test_planner_shard_weights_equal_the_reference():
    """One profile (branch costs 2, 1 and 4 ms), both planners: the same
    inverse-cost weights, and the port's plan reaches the element."""
    from nnstreamer_tpu.runtime import placement as rp
    from nnstreamer_tpu_torch.runtime import placement as pp

    art = _Artifact({"q0": 2.0, "q1": 1.0, "q2": 4.0})
    plans = []
    for mod, parse in ((pp, parse_launch), (rp, r_parse_launch)):
        pipe = parse(SHARD_PLACE)
        plan = mod.PlacementPlan()
        mod.Planner._shard_weights(mod.Planner.__new__(mod.Planner), pipe,
                                   art, plan)
        plans.append((pipe, plan))
    (pipe, plan), (_, rplan) = plans
    assert plan.shard_weights == rplan.shard_weights
    w = plan.shard_weights["s"]
    assert w == [round(x / 1.75, 6) for x in (0.5, 1.0, 0.25)]
    pp._apply(pipe, plan, [])
    assert pipe.get("s")._wrr[0] == pytest.approx(w)


class TestShardDistributed:
    def test_shard_across_query_workers(self):
        workers, ports = [], []
        try:
            for wid in (40, 41):
                w = parse_launch(
                    f"tensor_query_serversrc name=ssrc id={wid} port=0 "
                    "caps=other/tensors,format=static,dimensions=1,"
                    "types=float32 ! tensor_filter framework=torch "
                    "accelerator=cpu model=builtin://scaler?factor=100 "
                    f"! tensor_query_serversink id={wid}")
                w.play()
                workers.append(w)
                _wait(lambda: w.get("ssrc").bound_port != 0, 5)
                ports.append(w.get("ssrc").bound_port)
            pipe = parse_launch(
                "tensor_src num-buffers=8 dimensions=1 types=float32 "
                "pattern=counter ! tensor_shard name=s "
                f"s.src_0 ! queue ! tensor_query_client port={ports[0]} "
                f"! u.sink_0 s.src_1 ! queue ! tensor_query_client "
                f"port={ports[1]} ! u.sink_1 "
                "tensor_unshard name=u ! tensor_sink name=out max-stored=32")
            out = _collect(pipe, n=8, timeout=30)
            assert _vals(out) == [v * 100 for v in range(8)]
        finally:
            for w in workers:
                w.stop()


# ---------------------------------------------------------------------------
# gRPC (reference tests/test_grpc.py)
# ---------------------------------------------------------------------------

class TestGrpcPush:
    def test_push_roundtrip(self):
        recv = parse_launch(
            f"tensor_src_grpc name=g server=true port=0 caps={CAPS} "
            "! tensor_sink name=out max-stored=16")
        out = []
        recv.get("out").connect(out.append)
        recv.play()
        _wait(lambda: recv.get("g").bound_port != 0)
        port = recv.get("g").bound_port
        send = parse_launch(
            "tensor_src num-buffers=4 dimensions=4 types=float32 "
            f"pattern=counter ! tensor_sink_grpc server=false port={port}")
        send.play()
        send.wait(timeout=10)
        _wait(lambda: len(out) >= 4)
        send.stop()
        recv.stop()
        np.testing.assert_allclose(np.asarray(out[2].tensors[0]),
                                   np.full(4, 2, np.float32))

    def test_push_caps_mismatch_rejected(self):
        from nnstreamer_tpu_torch.core import parse_caps_string
        from nnstreamer_tpu_torch.query.grpc_io import GrpcTensorClient

        recv = parse_launch(
            f"tensor_src_grpc name=g server=true port=0 caps={CAPS} "
            "! tensor_sink name=out")
        recv.play()
        _wait(lambda: recv.get("g").bound_port != 0)
        c = GrpcTensorClient("127.0.0.1", recv.get("g").bound_port)
        try:
            c.start_send(parse_caps_string(
                "other/tensors,format=static,dimensions=8,types=int32"))
            c.send(Buffer([np.zeros(8, np.int32)]))
            with pytest.raises(Exception):
                c.finish_send(timeout=5)
        finally:
            c.close()
            recv.stop()


class TestGrpcPull:
    def test_pull_roundtrip(self):
        serve = parse_launch(f"appsrc name=in caps={CAPS} "
                             "! tensor_sink_grpc name=g server=true port=0")
        serve.play()
        _wait(lambda: serve.get("g").bound_port != 0)
        pull = parse_launch(
            f"tensor_src_grpc server=false port={serve.get('g').bound_port} "
            "! tensor_sink name=out max-stored=16")
        out = []
        pull.get("out").connect(out.append)
        pull.play()
        _wait(lambda: pull.get("out").sinkpad.caps is not None)
        src = serve.get("in")
        for i in range(3):
            src.push_buffer(np.full(4, i * 10, np.float32))
        _wait(lambda: len(out) >= 3)
        src.end_of_stream()
        pull.wait(timeout=10)
        pull.stop()
        serve.stop()
        np.testing.assert_allclose(np.asarray(out[1].tensors[0]), 10.0)

    def test_pull_caps_negotiated_from_server(self):
        serve = parse_launch(f"appsrc name=in caps={CAPS} "
                             "! tensor_sink_grpc name=g server=true port=0")
        serve.play()
        _wait(lambda: serve.get("g").bound_port != 0)
        pull = parse_launch(
            f"tensor_src_grpc server=false port={serve.get('g').bound_port} "
            "! tensor_sink name=out")
        pull.play()
        _wait(lambda: pull.get("out").sinkpad.caps is not None)
        assert "dimensions=4" in str(pull.get("out").sinkpad.caps)
        pull.stop()
        serve.stop()


class TestGrpcThroughFilter:
    def test_offload_subgraph(self):
        worker = parse_launch(
            f"tensor_src_grpc name=win server=true port=0 caps={CAPS} "
            "! tensor_filter framework=torch accelerator=cpu "
            "model=builtin://scaler?factor=5 "
            "! tensor_sink_grpc name=wout server=true port=0")
        worker.play()
        _wait(lambda: worker.get("win").bound_port != 0)
        _wait(lambda: worker.get("wout").bound_port != 0)
        results = parse_launch(
            f"tensor_src_grpc server=false port={worker.get('wout').bound_port}"
            " ! tensor_sink name=out max-stored=16")
        out = []
        results.get("out").connect(out.append)
        results.play()
        _wait(lambda: results.get("out").sinkpad.caps is not None)
        feeder = parse_launch(
            "tensor_src num-buffers=3 dimensions=4 types=float32 "
            "pattern=counter ! tensor_sink_grpc server=false "
            f"port={worker.get('win').bound_port}")
        feeder.play()
        feeder.wait(timeout=10)
        _wait(lambda: len(out) >= 3)
        feeder.stop()
        results.stop()
        worker.stop()
        np.testing.assert_allclose(np.asarray(out[1].tensors[0]),
                                   np.full(4, 5, np.float32))


@pytest.mark.parametrize("idl", ["own", "protobuf", "flatbuf"])
@pytest.mark.parametrize("sender", ["reference", "port"])
def test_grpc_push_across_packages_bytes_equal(sender, idl):
    """One package's client sink pushes into the other's server src."""
    recv_parse, send_parse = ((parse_launch, r_parse_launch)
                              if sender == "reference"
                              else (r_parse_launch, parse_launch))
    recv = recv_parse(f"tensor_src_grpc name=g server=true port=0 "
                      f"caps={CAPS} ! tensor_sink name=out max-stored=16")
    out = []
    recv.get("out").connect(out.append)
    recv.play()
    try:
        _wait(lambda: recv.get("g").bound_port != 0)
        frames = [np.random.default_rng(i).standard_normal(4).astype(
            np.float32) for i in range(3)]
        send = send_parse(f"appsrc name=in caps={CAPS} ! tensor_sink_grpc "
                          f"server=false idl={idl} "
                          f"port={recv.get('g').bound_port}")
        send.play()
        for f in frames:
            send.get("in").push_buffer(f)
        send.get("in").end_of_stream()
        send.wait(timeout=10)
        _wait(lambda: len(out) >= 3)
        send.stop()
    finally:
        recv.stop()
    for b, f in zip(out, frames):
        assert np.asarray(b.as_numpy().tensors[0]).tobytes() == f.tobytes()


@pytest.fixture
def no_grpc(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)


@pytest.mark.parametrize("line", [
    f"tensor_src_grpc server=true port=0 caps={CAPS} ! tensor_sink name=out",
    "tensor_src num-buffers=2 dimensions=4 types=float32 "
    "! tensor_sink_grpc server=false port=1 name=out"])
def test_without_grpc_the_elements_post_a_typed_error(no_grpc, line):
    from nnstreamer_tpu_torch.backends.base import FrameworkUnavailable
    from nnstreamer_tpu_torch.query.grpc_io import GrpcTensorService

    with pytest.raises(FrameworkUnavailable, match="grpc"):
        GrpcTensorService("127.0.0.1", 0)
    pipe = parse_launch(line)
    got = []
    sink = pipe.get("out")
    if hasattr(sink, "connect"):
        sink.connect(got.append)
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
    pipe.stop()
    assert msg is not None and "grpc" in str(msg.data["error"])
    assert got == []


# ---------------------------------------------------------------------------
# IDL codecs (reference tests/test_wire_formats.py)
# ---------------------------------------------------------------------------

def _sample_arrays():
    rng = np.random.default_rng(3)
    return [rng.random((2, 3, 4)).astype(np.float32),
            rng.integers(0, 255, (5,)).astype(np.uint8),
            rng.integers(-100, 100, (1, 7)).astype(np.int32)]


class TestProtobufWire:
    def test_roundtrip(self):
        arrays = _sample_arrays()
        blob = wire_protobuf.encode_tensors(arrays, ["a", "", "c"],
                                            rate=(30, 1))
        out, names, fmt, rate = wire_protobuf.decode_tensors(blob)
        assert rate == (30, 1) and fmt is TensorFormat.STATIC
        assert names == ["a", "", "c"]
        for x, y in zip(arrays, out):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    def test_bytes_match_protobuf_runtime(self, pb2):
        arrays = _sample_arrays()
        blob = wire_protobuf.encode_tensors(arrays, ["a", "", "c"],
                                            rate=(30, 1))
        msg = pb2.Tensors()
        msg.num_tensor = len(arrays)
        msg.fr.rate_n, msg.fr.rate_d = 30, 1
        for i, a in enumerate(arrays):
            t = msg.tensor.add()
            t.name = ["a", "", "c"][i]
            t.type = wire_protobuf.wire_type_of(
                wire_protobuf.DataType.from_any(a.dtype))
            t.dimension.extend(wire_protobuf.dims_of(a.shape))
            t.data = a.tobytes()
        assert blob == msg.SerializeToString()

    def test_decode_runtime_bytes(self, pb2):
        a = np.arange(12, dtype=np.int16).reshape(3, 4)
        msg = pb2.Tensors()
        msg.num_tensor = 1
        msg.format = 1
        t = msg.tensor.add()
        t.type = 2
        t.dimension.extend(wire_protobuf.dims_of(a.shape))
        t.data = a.tobytes()
        arrays, _names, fmt, _rate = wire_protobuf.decode_tensors(
            msg.SerializeToString())
        assert fmt is TensorFormat.FLEXIBLE
        assert np.array_equal(arrays[0], a)


class TestFlatbufWire:
    def test_roundtrip(self):
        arrays = _sample_arrays()
        blob = wire_flatbuf.encode_tensors(arrays, ["x", "y", ""],
                                           fmt=TensorFormat.FLEXIBLE,
                                           rate=(25, 2))
        out, names, fmt, rate = wire_flatbuf.decode_tensors(blob)
        assert fmt is TensorFormat.FLEXIBLE and rate == (25, 2)
        assert names == ["x", "y", ""]
        for x, y in zip(arrays, out):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    def test_decode_official_bytes(self):
        from test_wire_formats import TestFlatbufWire as RefFlatbuf

        arrays = _sample_arrays()
        blob = RefFlatbuf._official_encode(None, arrays, ["x", "y", ""], 2,
                                           (25, 2))
        out, names, fmt, rate = wire_flatbuf.decode_tensors(blob)
        assert fmt is TensorFormat.SPARSE and rate == (25, 2)
        assert names == ["x", "y", ""]
        for x, y in zip(arrays, out):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    def test_official_decodes_our_bytes(self):
        import flatbuffers
        from flatbuffers import number_types as nt

        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        buf = bytearray(wire_flatbuf.encode_tensors([a], ["t0"],
                                                    rate=(30, 1)))
        n = flatbuffers.encode.Get(nt.UOffsetTFlags.packer_type, buf, 0)
        tab = flatbuffers.table.Table(buf, n)
        o = tab.Offset(4)
        assert tab.Get(nt.Int32Flags, o + tab.Pos) == 1
        o = tab.Offset(6)
        assert tab.Get(nt.Int32Flags, o + tab.Pos) == 30
        assert tab.Get(nt.Int32Flags, o + tab.Pos + 4) == 1
        o = tab.Offset(8)
        t = flatbuffers.table.Table(buf, tab.Indirect(tab.Vector(o)))
        assert t.String(t.Offset(4) + t.Pos) == b"t0"
        d_off = t.Offset(10)
        start = t.Vector(d_off)
        assert bytes(buf[start:start + t.VectorLen(d_off)]) == a.tobytes()


@pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
def test_decoder_converter_loop(idl):
    x = np.random.default_rng(5).random((4, 3)).astype(np.float32)
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions=3:4,types=float32 ! tensor_decoder mode={idl} "
        "! tensor_converter ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    pipe.get("in").push_buffer(x)
    pipe.get("in").end_of_stream()
    pipe.wait(timeout=20)
    pipe.stop()
    out = np.asarray(got[0].as_numpy().tensors[0])
    assert out.dtype == np.float32 and np.array_equal(out, x)
