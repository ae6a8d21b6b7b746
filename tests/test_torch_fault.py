"""tensor_fault and NetworkChaos (elements/fault.py): the port against
nnstreamer_tpu.

The same launch line with the same seed and properties runs through
both packages; the buffers at the sink (dtype, shape, raw bytes —
bfloat16 as its 16-bit words) and the element's ``stats`` must be
equal: numpy's ``default_rng(seed)`` makes drops, delays, corruption and
duplicates fall on the same buffers. Host bfloat16 passes the numerical
modes untouched in both (the reference's is an ``ml_dtypes`` array, not
a numpy float), and corruption flips the same bytes of it."""
import socket

import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.fault import NetworkChaos as JNetworkChaos
from nnstreamer_tpu.query.protocol import MsgType
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer as tsan
from nnstreamer_tpu_torch.elements.fault import NetworkChaos
from nnstreamer_tpu_torch.registry.elements import element_factories
from nnstreamer_tpu_torch.runtime.parse import parse_launch

LINE = ("tensor_src name=src num-buffers={n} dimensions={dims} "
        "types={types} pattern=counter ! tensor_fault name=flt {props} "
        "! tensor_sink name=out max-stored=256")


@pytest.fixture(autouse=True)
def _tsan_clean():
    before = len(tsan.violations())
    yield
    assert tsan.violations()[before:] == []


def _as_bytes(t):
    if isinstance(t, torch.Tensor):
        t = t.cpu()
        if t.dtype is torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    t.contiguous().view(torch.int16).numpy().tobytes())
        t = t.numpy()
    a = np.asarray(t)
    name = "bfloat16" if a.dtype.name == "bfloat16" else str(a.dtype)
    return name, a.shape, np.ascontiguousarray(a).tobytes()


def _run(parse, line, replays=1):
    pipe = parse(line)
    runs = []
    got = []
    pipe.get("out").connect(got.append)
    for _ in range(replays):
        del got[:]
        # a run that ended in an ERROR may have posted its EOS behind it
        # (the source finished before the error halt stopped it): that
        # message belongs to the finished run, not to the replay's wait
        while pipe.bus.pop(timeout=0) is not None:
            pass
        pipe.play()
        msg = pipe.wait(timeout=60)
        pipe.stop()
        runs.append((msg.type.value, dict(pipe.get("flt").stats),
                     [[_as_bytes(t) for t in b.tensors] for b in got]))
    return runs


def _same(props, n=16, dims="8", types="float32", replays=1):
    line = LINE.format(n=n, dims=dims, types=types, props=props)
    got = _run(parse_launch, line, replays)
    want = _run(jax_parse_launch, line, replays)
    assert got == want
    return got


@pytest.mark.parametrize("props", [
    "", "drop-prob=0.3 seed=5", "dup-prob=0.4 seed=1",
    "corrupt-prob=0.5 seed=2", "delay-prob=0.5 delay-ms=2 seed=3",
    "nan-at-buffer=3", "inf-at-buffer=0", "scale-drift=4",
    "drop-prob=0.2 dup-prob=0.2 corrupt-prob=0.3 scale-drift=0.5 seed=11",
])
def test_float_stream_bytes_and_stats_match(props):
    (msg, stats, bufs), = _same(props)
    assert msg == "eos"
    assert stats["passed"] + stats["dropped"] == 16
    assert len(bufs) == stats["passed"] + stats["duplicated"]


def test_nan_and_inf_both_armed_inject_both():
    (_, stats, bufs), = _same("nan-at-buffer=0 inf-at-buffer=0", dims="64")
    assert stats["nan_injected"] == stats["inf_injected"] == 16
    a = np.frombuffer(bufs[0][0][2], np.float32)
    assert np.isnan(a[:4]).all() and np.isinf(a[4:8]).all()


@pytest.mark.parametrize("types", ["uint8", "int32"])
@pytest.mark.parametrize("props", ["nan-at-buffer=0 scale-drift=4",
                                   "corrupt-prob=0.6 seed=9"])
def test_int_streams_match(types, props):
    (_, stats, _), = _same(props, types=types)
    assert stats["nan_injected"] == 0 and stats["scaled"] == 0


@pytest.mark.parametrize("props", ["nan-at-buffer=0 scale-drift=4",
                                   "corrupt-prob=0.7 seed=4"])
def test_host_bfloat16_matches(props):
    (_, stats, bufs), = _same(props, types="bfloat16")
    assert stats["nan_injected"] == 0 and stats["scaled"] == 0
    assert all(b[0][0] == "bfloat16" for b in bufs)


def test_crash_at_buffer_is_one_shot_across_replays():
    """After the crash the source runs on until the pipeline's error halt
    stops it, so how many more buffers cross the element in the first
    run (and whether that run's EOS lands on the bus behind its ERROR)
    is timing in both packages. What the semantics fix is compared
    exactly: the message, ``crashed``, the buffers before the crash and
    the whole second replay."""
    line = LINE.format(n=16, dims="8", types="float32",
                       props="crash-at-buffer=2")
    got = _run(parse_launch, line, replays=2)
    want = _run(jax_parse_launch, line, replays=2)

    def fixed(runs):
        (msg, stats, bufs), replay = runs
        return msg, stats["crashed"], bufs[:2], replay

    assert fixed(got) == fixed(want)
    assert got[0][0] == "error" and got[0][1]["crashed"] == 1
    assert len(got[0][2]) >= 2
    assert got[1][0] == "eos" and got[1][1]["crashed"] == 0


def test_replay_resets_the_rng():
    runs = _same("drop-prob=0.4 corrupt-prob=0.4 seed=21", replays=2)
    assert runs[0] == runs[1]


def test_fault_on_device_path_output():
    """After a filter (a device-path tensor) the numerical modes work on
    the host copy, as in the reference."""
    line = ("tensor_src name=src num-buffers=6 dimensions=4:2 types=float32 "
            "pattern=counter ! tensor_filter framework={fw} {acc}"
            "model=builtin://scaler?factor=2 ! tensor_fault name=flt "
            "nan-at-buffer=2 ! tensor_sink name=out")
    got = _run(parse_launch, line.format(fw="torch", acc="accelerator=cpu "))
    want = _run(jax_parse_launch, line.format(fw="jax", acc=""))
    assert got == want
    assert got[0][1]["nan_injected"] == 4


def test_registered_with_the_reference_properties():
    assert "tensor_fault" in element_factories()
    from nnstreamer_tpu.elements.fault import TensorFault as J
    from nnstreamer_tpu_torch.elements.fault import TensorFault as T

    assert {k: (p.default, p.doc) for k, p in T.PROPERTIES.items()} == \
        {k: (p.default, p.doc) for k, p in J.PROPERTIES.items()}


# -- NetworkChaos ---------------------------------------------------------------

@pytest.fixture
def chaos():
    port, ref = NetworkChaos(), JNetworkChaos()
    yield port, ref
    port.clear()
    ref.clear()


def _exercise(nc, data_type, a, b):
    out = []
    bport = b.getsockname()[1]
    nc.partition_for_s(4242, 60.0)
    with pytest.raises(ConnectionRefusedError) as ei:
        nc._on_connect("localhost", 4242)
    out.append(str(ei.value))
    nc._on_connect("localhost", 4243)  # other ports unaffected
    nc.delay_ms(bport, 1.0)
    nc._on_send(a, data_type)
    nc.drop_conn_at(bport, 2)
    nc._on_send(a, data_type)
    nc._on_send(a, data_type)
    with pytest.raises(ConnectionResetError) as ei:
        nc._on_send(a, data_type)
    out.append(str(ei.value))
    out.append(nc.snapshot())
    return out


def test_network_chaos_rules_match(chaos):
    results = []
    for nc, data_type in zip(chaos, (MsgType.DATA, MsgType.DATA)):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        a = socket.create_connection(srv.getsockname())
        b, _ = srv.accept()
        try:
            results.append(_exercise(nc, data_type, a, b))
        finally:
            for s in (a, b, srv):
                s.close()
    # the peer ports differ between the two runs: compare the rest
    port, ref = results
    assert port[0] == ref[0]
    assert port[2] == ref[2]
    assert port[2] == {"armed": True, "rules": 2, "killed_conns": 1,
                       "delayed_sends": 3, "partition_refusals": 1}
    chaos[0].clear()
    assert chaos[0].snapshot()["armed"] is False
