"""The port's tensor query (``query/{client,server,elements}.py``) and its
observability and fault hooks (``obs/promtext.py``, the ``wire`` collector,
``NetworkChaos``'s transport hooks) against nnstreamer_tpu's.

* the cases of the reference's ``tests/test_query.py`` (loopback echo,
  multi-client routing, caps rejection) on the port's launch lines;
* the slice end to end at ``lm_serving:tiny`` on the CPU: tokens offloaded
  through ``tensor_query_client`` → ``tensor_query_serversrc ! tensor_filter
  ! tensor_query_serversink`` equal nnstreamer_tpu's filter line on the
  same prompts and weights (carried by ``models/convert.py``), over NNSB
  with shm and over JSON; a reference client line against the port's LM
  server and the port's client line against a reference server; the
  server in a child process (shm across processes);
* ``QueryServer.attach_scheduler`` (the reference's
  ``tests/test_serving.py::TestQueryServerBridge``): clients released by
  a barrier share one scheduler batch, with the reference's answers;
* the shared-server registry, the Prometheus parser, the wire collector and
  the chaos hooks, each against the reference's behaviour.

The reference's query tests that failed in some runs are mirrored by
comparing outputs, never by their assertions. Every wait is bounded."""
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu.runtime.parse import parse_launch as r_parse_launch
from nnstreamer_tpu_torch.core import Buffer, Caps, MessageType
from nnstreamer_tpu_torch.models import lm_serving
from nnstreamer_tpu_torch.query import protocol
from nnstreamer_tpu_torch.query.client import QueryClient
from nnstreamer_tpu_torch.query.server import (QueryServer,
                                               get_shared_server,
                                               lookup_shared_server,
                                               release_shared_server)
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.serving import Scheduler
from nnstreamer_tpu_torch.transport import stats as wire_stats

ROOT = Path(__file__).resolve().parents[1]
MODULE = __name__
CARRIED = None   # the port's tiny entry with nnstreamer_tpu's tiny weights
WAIT = 30.0
VEC_CAPS = "other/tensors,format=static,dimensions=4,types=float32"


def _wait(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert cond()


def start_server(parse, model: str, server_id: int, caps=VEC_CAPS,
                 framework="torch accelerator=cpu"):
    pipe = parse(
        f"tensor_query_serversrc name=ssrc id={server_id} port=0 "
        f"caps={caps} ! tensor_filter framework={framework} model={model} "
        f"! tensor_query_serversink id={server_id}")
    pipe.play()
    _wait(lambda: pipe.get("ssrc").bound_port != 0, 5)
    return pipe, pipe.get("ssrc").bound_port


# ---------------------------------------------------------------------------
# the reference's loopback cases
# ---------------------------------------------------------------------------

class TestQueryLoopback:
    def test_echo_roundtrip(self):
        server, port = start_server(parse_launch,
                                    "builtin://scaler?factor=3", 30)
        try:
            client = parse_launch(
                f"appsrc name=in caps={VEC_CAPS} "
                f"! tensor_query_client host=127.0.0.1 port={port} "
                "! tensor_sink name=out")
            out = []
            client.get("out").connect(out.append)
            client.play()
            src = client.get("in")
            for i in range(3):
                src.push_buffer(np.full(4, i, np.float32))
            src.end_of_stream()
            _wait(lambda: len(out) >= 3, 10)
            client.stop()
            assert len(out) == 3
            assert np.allclose(np.asarray(out[1].tensors[0]), 3.0)
        finally:
            server.stop()

    def test_multi_client_routing(self):
        server, port = start_server(parse_launch, "builtin://passthrough", 31)
        clients, outs = [], []
        try:
            for _ in range(3):
                pipe = parse_launch(
                    f"appsrc name=in caps={VEC_CAPS} "
                    f"! tensor_query_client host=127.0.0.1 port={port} "
                    "! tensor_sink name=out")
                collected = []
                pipe.get("out").connect(collected.append)
                pipe.play()
                clients.append(pipe)
                outs.append(collected)
            for c, pipe in enumerate(clients):
                pipe.get("in").push_buffer(np.full(4, c * 10.0, np.float32))
            _wait(lambda: all(len(o) >= 1 for o in outs), 10)
            for c, collected in enumerate(outs):
                assert len(collected) == 1
                assert np.allclose(np.asarray(collected[0].tensors[0]),
                                   c * 10.0)
        finally:
            for pipe in clients:
                pipe.stop()
            server.stop()

    def test_caps_mismatch_rejected(self):
        server, port = start_server(parse_launch, "builtin://passthrough", 32)
        try:
            client = parse_launch(
                "appsrc name=in caps=other/tensors,format=static,"
                "dimensions=9,types=int32 "
                f"! tensor_query_client host=127.0.0.1 port={port} "
                "! tensor_sink name=out")
            client.play()
            msg = client.bus.wait_for((MessageType.ERROR,), timeout=5)
            client.stop()
            assert msg is not None and "rejected" in msg.data["error"]
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# the slice end to end at lm_serving:tiny
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    cfg = jtr.TransformerConfig(vocab=64, dim=32, heads=4, layers=2,
                                max_seq=64)
    tree = jax.tree_util.tree_map(np.asarray, jtr.init_params(cfg, seed=0))
    entry = dataclasses.replace(lm_serving.tiny, params=tree)
    setattr(sys.modules[MODULE], "CARRIED", entry)
    return entry


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 64, (4, 6)).astype(np.int32) for _ in range(3)]


LM_CAPS = "other/tensors,format=static,dimensions=6:4,types=int32"


@pytest.fixture(scope="module")
def reference_tokens(prompts):
    """nnstreamer_tpu's filter line on the prompts."""
    pipe = r_parse_launch(
        f"appsrc name=in caps={LM_CAPS} ! tensor_filter framework=jax "
        "model=nnstreamer_tpu.models.lm_serving:tiny "
        f"! tensor_sink name=out max-stored={len(prompts)}")
    outs = []
    pipe.get("out").connect(outs.append)
    pipe.play()
    try:
        for p in prompts:
            pipe.get("in").push_buffer(p)
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    return [np.asarray(o.tensors[0]) for o in outs]


def offload(parse, port: int, prompts, wire: str = "auto"):
    """Push the prompts through a query client line; returns the outputs
    and the client element."""
    pipe = parse(
        f"appsrc name=in caps={LM_CAPS} ! tensor_query_client name=qc "
        f"host=127.0.0.1 port={port} wire={wire} timeout=60 "
        f"! tensor_sink name=out max-stored={len(prompts)}")
    outs = []
    pipe.get("out").connect(outs.append)
    pipe.play()
    try:
        for p in prompts:
            pipe.get("in").push_buffer(p)
        _wait(lambda: len(outs) >= len(prompts), 120)
        qc = pipe.get("qc").client
        info = {"wire": qc.wire_format, "shm": qc.shm_active}
    finally:
        pipe.stop()
    return [np.asarray(o.as_numpy().tensors[0]) for o in outs], info


@pytest.mark.parametrize("wire", ["auto", "json"])
def test_offloaded_tokens_equal_the_reference_filter_line(
        carried, prompts, reference_tokens, wire):
    server, port = start_server(parse_launch, f"{MODULE}:CARRIED", 33,
                                caps=LM_CAPS)
    try:
        got, info = offload(parse_launch, port, prompts, wire)
    finally:
        server.stop()
    assert info == ({"wire": "binary", "shm": True} if wire == "auto"
                    else {"wire": "json", "shm": False})
    assert len(got) == len(reference_tokens) == len(prompts)
    for g, w, p in zip(got, reference_tokens, prompts):
        np.testing.assert_array_equal(g[:, :6], p)
        np.testing.assert_array_equal(g, w)


def test_reference_client_line_against_the_port_lm_server(
        carried, prompts, reference_tokens):
    server, port = start_server(parse_launch, f"{MODULE}:CARRIED", 34,
                                caps=LM_CAPS)
    try:
        got, info = offload(r_parse_launch, port, prompts)
    finally:
        server.stop()
    assert info == {"wire": "binary", "shm": True}
    for g, w in zip(got, reference_tokens):
        np.testing.assert_array_equal(g, w)


def test_port_client_line_against_a_reference_server(prompts,
                                                     reference_tokens):
    server, port = start_server(
        r_parse_launch, "nnstreamer_tpu.models.lm_serving:tiny", 35,
        caps=LM_CAPS, framework="jax")
    try:
        got, info = offload(parse_launch, port, prompts)
    finally:
        server.stop()
    assert info == {"wire": "binary", "shm": True}
    for g, w in zip(got, reference_tokens):
        np.testing.assert_array_equal(g, w)


CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.modules["jax"] = None
sys.modules["nnstreamer_tpu"] = None
from nnstreamer_tpu_torch.runtime.parse import parse_launch
pipe = parse_launch(sys.argv[2])
pipe.play()
print(json.dumps({"port": pipe.get("ssrc").bound_port}), flush=True)
sys.stdin.readline()          # the parent closes stdin to stop us
pipe.stop()
print(json.dumps({"stopped": True}), flush=True)
"""


def _read_json_line(proc, timeout: float) -> dict:
    got = {}

    def read():
        got["line"] = proc.stdout.readline()
    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    assert "line" in got, "child printed nothing in time"
    return json.loads(got["line"])


def test_server_in_a_child_process_with_shm(prompts):
    """The server line runs in its own process (importing only the port):
    the handshake proves the same host, so NNSB with the shm ring carries
    the frames across processes, and the tokens equal the local filter
    line's."""
    line = ("tensor_query_serversrc name=ssrc id=0 port=0 "
            f"caps={LM_CAPS} ! tensor_filter framework=torch accelerator=cpu "
            "model=nnstreamer_tpu_torch.models.lm_serving:tiny "
            "! tensor_query_serversink id=0")
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(ROOT), line],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        port = _read_json_line(proc, 120)["port"]
        before = wire_stats.snapshot()["frames"].get("shm:tx", 0)
        got, info = offload(parse_launch, port, prompts)
        assert info == {"wire": "binary", "shm": True}
        assert wire_stats.snapshot()["frames"]["shm:tx"] - before == 3
        proc.stdin.close()
        assert _read_json_line(proc, 60) == {"stopped": True}
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    local = parse_launch(
        f"appsrc name=in caps={LM_CAPS} ! tensor_filter framework=torch "
        "accelerator=cpu model=nnstreamer_tpu_torch.models.lm_serving:tiny "
        f"! tensor_sink name=out max-stored={len(prompts)}")
    want = []
    local.get("out").connect(want.append)
    local.play()
    try:
        for p in prompts:
            local.get("in").push_buffer(p)
        local.get("in").end_of_stream()
        local.wait(timeout=120)
    finally:
        local.stop()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.as_numpy().tensors[0])


# ---------------------------------------------------------------------------
# attach_scheduler (reference tests/test_serving.py::TestQueryServerBridge)
# ---------------------------------------------------------------------------

def _bridge_run(pkg: str, n_clients: int = 4):
    if pkg == "port":
        from nnstreamer_tpu_torch.core import Buffer as B, Caps as C
        from nnstreamer_tpu_torch.query.client import QueryClient as QC
        from nnstreamer_tpu_torch.query.server import QueryServer as QS
        from nnstreamer_tpu_torch.serving import Scheduler as S
    else:
        from nnstreamer_tpu.core import Buffer as B, Caps as C
        from nnstreamer_tpu.query.client import QueryClient as QC
        from nnstreamer_tpu.query.server import QueryServer as QS
        from nnstreamer_tpu.serving import Scheduler as S
    caps = C.new("other/tensors")
    server = QS(port=0, caps=caps)
    # one bucket of 4 rows: 1-3 queued rows are never a bucket boundary,
    # so neither batcher flushes them early (an idle worker flushes a cell
    # only on a boundary), and the 4th row fills the bucket at once; the
    # long max_wait only bounds a run whose clients never all send
    sched = S(lambda x: (x * 2 + 1,), bucket_sizes=(n_clients,),
              max_wait_s=5.0, name=f"t-qbridge-{pkg}")
    server.attach_scheduler(sched)
    results = {}
    barrier = threading.Barrier(n_clients, timeout=WAIT)

    def client(i):
        c = QC("127.0.0.1", server.port)
        try:
            c.connect(caps)
            barrier.wait()          # every client is connected: send now
            c.send(B([np.full((1, 3), float(i), np.float32)]))
            results[i] = c.responses.get(timeout=WAIT)
        finally:
            c.close()

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        snap = sched.metrics_snapshot()
    finally:
        sched.close()
        server.stop()
    outs = [np.asarray(results[i].tensors[0]) for i in range(n_clients)]
    return outs, snap


def test_attach_scheduler_clients_share_a_batch_like_the_reference():
    got, snap = _bridge_run("port")
    want, _ = _bridge_run("reference")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert snap["completed"] == 4
    assert snap["batches"] < 4


def test_attach_scheduler_twice_raises():
    server = QueryServer(port=0)
    sched = Scheduler(lambda x: (x,), bucket_sizes=(1,), name="t-twice")
    try:
        server.attach_scheduler(sched)
        with pytest.raises(RuntimeError, match="already attached"):
            server.attach_scheduler(sched)
    finally:
        sched.close()
        server.stop()


# ---------------------------------------------------------------------------
# shared-server registry
# ---------------------------------------------------------------------------

def test_lookup_without_a_server_names_the_id_like_the_reference():
    from nnstreamer_tpu.query.server import lookup_shared_server as r_lookup

    with pytest.raises(KeyError) as got:
        lookup_shared_server(991, timeout=0.1)
    with pytest.raises(KeyError) as want:
        r_lookup(991, timeout=0.1)
    assert str(got.value).replace("0.1s", "") == \
        str(want.value).replace("0.1s", "")


def test_shared_server_is_refcounted():
    srv = get_shared_server(992)
    try:
        assert lookup_shared_server(992, timeout=1) is srv
        release_shared_server(992)
        assert lookup_shared_server(992, timeout=1) is srv   # still held
        release_shared_server(992)
    finally:
        release_shared_server(992)
    with pytest.raises(KeyError):
        lookup_shared_server(992, timeout=0.05)


# ---------------------------------------------------------------------------
# promtext and the wire collector
# ---------------------------------------------------------------------------

PROM_TEXT = """# HELP nns_x help
# TYPE nns_x counter
nns_x{a="1,2",b="q\\"uote"} 3
nns_x_total 4
nns_h_bucket{le="0.5"} 1
nns_h_sum 0.25
nns_y{path="c:\\\\d",nl="a\\nb"} -1.5e3

"""


def test_promtext_parses_like_the_reference():
    from nnstreamer_tpu.obs import promtext as rp
    from nnstreamer_tpu_torch.obs import promtext as pp

    assert pp.parse_samples(PROM_TEXT) == rp.parse_samples(PROM_TEXT)
    for name, labels in (("nns_x", {"b": 'q"uote'}), ("nns_x_total", None),
                         ("nns_h", {"le": "0.5"}), ("nns_y", None)):
        assert pp.sample(PROM_TEXT, name, labels) == \
            rp.sample(PROM_TEXT, name, labels)
    assert pp.samples_named(PROM_TEXT, "nns_x") == \
        rp.samples_named(PROM_TEXT, "nns_x")


def test_wire_collector_renders_the_negotiated_plane():
    from nnstreamer_tpu_torch.obs import metrics, promtext

    wire_stats.reset()
    server, port = start_server(parse_launch, "builtin://passthrough", 36)
    try:
        cli = QueryClient("127.0.0.1", port, wire="json")
        try:
            cli.connect(Caps.new("other/tensors", format="static",
                                 dimensions="4", types="float32"))
            cli.request(Buffer([np.ones(4, np.float32)]), timeout=WAIT)
            text = metrics.render()
        finally:
            cli.close()
    finally:
        server.stop()
    assert promtext.sample(text, "nns_wire_negotiated_total",
                           {"format": "json"}) == 2.0
    assert promtext.sample(text, "nns_wire_frames_total",
                           {"format": "json", "direction": "tx"}) == 2.0
    assert promtext.sample(text, "nns_wire_d2h_bytes_total") == 0.0


@pytest.mark.parametrize("caps,want", [
    (VEC_CAPS, 1 << 20),
    ("other/tensors,format=static,dimensions=3:224:224:64,types=uint8",
     24 + 80 + 3 * 224 * 224 * 64 + (64 << 10)),
    ("other/tensors,format=static,num_tensors=2,dimensions=1024:1024.4,"
     "types=float32.int8", 24 + 2 * 80 + 4 * 1024 * 1024 + 4 + (64 << 10)),
    ("other/tensors,format=static,dimensions=4096:4096:8,types=float32",
     64 << 20),
    ("other/tensors,format=flexible", 1 << 20),
    ("other/tensors,format=static", 1 << 20),
], ids=["small", "mobilenet-batch", "two-tensors", "capped", "flexible",
        "unfixed"])
def test_client_ring_slots_follow_the_caps(caps, want):
    from nnstreamer_tpu_torch.core import parse_caps_string
    from nnstreamer_tpu_torch.query.client import c2s_slot_bytes

    assert c2s_slot_bytes(parse_caps_string(caps)) == want


def test_client_line_frames_above_the_default_slot_ride_the_rings():
    """A tensor_query_client line whose static frames (2 MiB) exceed the
    default 1 MiB slot: both rings are sized from the stream, so every
    frame crosses by descriptor each way, none inline."""
    caps = "other/tensors,format=static,dimensions=1024:2048,types=uint8"
    server, port = start_server(parse_launch, "builtin://passthrough", 37,
                                caps=caps)
    frames = np.random.default_rng(37).integers(
        0, 256, (3, 2048, 1024), dtype=np.uint8)
    before = wire_stats.snapshot()
    try:
        client = parse_launch(
            f"appsrc name=in caps={caps} ! tensor_query_client name=qc "
            f"host=127.0.0.1 port={port} ! tensor_sink name=out")
        out = []
        client.get("out").connect(out.append)
        client.play()
        try:
            for f in frames:
                client.get("in").push_buffer(f)
            _wait(lambda: len(out) >= 3)
            qc = client.get("qc").client
            assert (qc.wire_format, qc.shm_active) == ("binary", True)
            assert qc._ring.slot_bytes > 2 * 1024 * 1024
        finally:
            client.stop()
    finally:
        server.stop()
    after = wire_stats.snapshot()

    def delta(group, key):
        return after[group].get(key, 0) - before[group].get(key, 0)
    # client and server share this process: each frame is counted by the
    # sender and by the receiver, in both directions
    assert {k: delta("frames", f"{k}") for k in
            ("shm:tx", "shm:rx", "binary:tx", "binary:rx")} == {
        "shm:tx": 6, "shm:rx": 6, "binary:tx": 0, "binary:rx": 0}
    assert delta("shm", "fallback_oversize") == 0
    for f, b in zip(frames, out):
        assert np.array_equal(np.asarray(b.tensors[0]), f)


# ---------------------------------------------------------------------------
# NetworkChaos bound to the port's transport
# ---------------------------------------------------------------------------

@pytest.fixture
def chaos():
    from nnstreamer_tpu_torch.elements.fault import net_chaos

    yield net_chaos
    net_chaos.clear()


def test_chaos_arming_installs_the_transport_hooks(chaos):
    assert protocol._send_fault_hook is None
    chaos.delay_ms(1, 0)
    assert protocol._send_fault_hook == chaos._on_send
    assert protocol._connect_fault_hook == chaos._on_connect
    chaos.clear()
    assert protocol._send_fault_hook is None


def test_chaos_partition_refuses_a_query_connect(chaos):
    server, port = start_server(parse_launch, "builtin://passthrough", 37)
    try:
        chaos.partition_for_s(port, 60)
        cli = QueryClient("127.0.0.1", port)
        with pytest.raises(ConnectionRefusedError, match="partitioned"):
            cli.connect(Caps.new("other/tensors"))
        cli.close()
        assert chaos.snapshot()["partition_refusals"] == 1
    finally:
        server.stop()


def test_chaos_drop_kills_a_live_link_typed(chaos):
    """The killed link surfaces as a typed disconnect, never a hang: the
    waiting request raises ConnectionError."""
    server, port = start_server(parse_launch, "builtin://passthrough", 38)
    try:
        cli = QueryClient("127.0.0.1", port)
        try:
            cli.connect(Caps.new("other/tensors", format="static",
                                 dimensions="4", types="float32"))
            cli.request(Buffer([np.ones(4, np.float32)]), timeout=WAIT)
            chaos.drop_conn_at(port, 0)
            with pytest.raises(ConnectionError):
                cli.request(Buffer([np.ones(4, np.float32)]), timeout=WAIT)
        finally:
            cli.close()
        assert chaos.snapshot()["killed_conns"] == 1
    finally:
        server.stop()
