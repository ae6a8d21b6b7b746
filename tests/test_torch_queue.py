"""The port's queue element (runtime/queue.py) against nnstreamer_tpu's on
the same pushes: the order of buffers and events, backpressure on a full
queue, the leaky=upstream / leaky=downstream drop counts and which
buffers survive, events that pass a full queue without blocking or being
dropped, FLUSH, and a stop() that releases a blocked producer."""
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.registry.elements as jreg
from nnstreamer_tpu.runtime import queue as jqueue
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.registry.elements as treg
from nnstreamer_tpu_torch.runtime import queue as tqueue
from nnstreamer_tpu_torch.runtime.parse import parse_launch

PKGS = {"port": (tcore, treg), "jax": (jcore, jreg)}
CAPS = "other/tensors,format=static,dimensions=2,types=int32"


def _queue(pkg: str, **props):
    """A queue linked to a tensor_sink, not started: pushes stay in it
    until start()."""
    core, reg = PKGS[pkg]
    q = reg.make_element("queue", **props)
    sink = reg.make_element("tensor_sink", max_stored=0)
    q.link(sink)
    got = []
    sink.connect(lambda b: got.append(int(np.asarray(b.tensors[0])[0])))
    return q, got


def _buf(pkg: str, i: int):
    return PKGS[pkg][0].Buffer([np.array([i, i], np.int32)])


def _pushes(n: int):
    """Channel items: buffers 0..n-1 with a CAPS event after the first."""
    return [("buf", 0), ("event", "caps")] + [("buf", i) for i in range(1, n)]


def _channel_run(pkg: str, capacity: int, leaky: str, n: int):
    core = PKGS[pkg][0]
    ch = (tqueue._Channel(capacity, leaky) if pkg == "port"
          else jqueue._Channel(capacity, leaky, name="t"))
    for kind, v in _pushes(n):
        if kind == "buf":
            ch.put_buf(_buf(pkg, v))
        else:
            ch.put_event(core.Event.caps(core.parse_caps_string(CAPS)))
    ch.put_stop()
    out = []
    while True:
        kind, payload = ch.get()
        if kind == "stop":
            break
        out.append(int(np.asarray(payload.tensors[0])[0]) if kind == "buf"
                   else payload.type.value)
    return out, (ch.dropped_upstream, ch.dropped_downstream)


@pytest.mark.parametrize("capacity", [0, 1, 2, 3])
@pytest.mark.parametrize("leaky", ["upstream", "downstream"])
def test_leaky_channel_matches_jax(leaky, capacity):
    got = _channel_run("port", capacity, leaky, 7)
    want = _channel_run("jax", capacity, leaky, 7)
    assert got == want
    order, drops = got
    assert "caps" in order                      # the event is never dropped
    assert sum(drops) == (0 if capacity == 0 else 7 - capacity)


@pytest.mark.parametrize("leaky", ["upstream", "downstream"])
def test_leaky_element_stats_match_jax(leaky):
    stats, outs = {}, {}
    for pkg in PKGS:
        q, got = _queue(pkg, max_size_buffers=2, leaky=leaky)
        for i in range(6):
            q.chain(q.sinkpad, _buf(pkg, i))
        s = q.stats
        stats[pkg] = {k: s[k] for k in ("level", "capacity", "leaky",
                                         "dropped_upstream",
                                         "dropped_downstream")}
        q.start()
        deadline = time.monotonic() + 5
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        q.stop()
        outs[pkg] = got
    assert stats["port"] == stats["jax"]
    assert outs["port"] == outs["jax"] == ([0, 1] if leaky == "upstream"
                                           else [4, 5])


@pytest.mark.parametrize("pkg", list(PKGS))
def test_events_pass_a_full_queue(pkg):
    core = PKGS[pkg][0]
    q, got = _queue(pkg, max_size_buffers=1)
    q.chain(q.sinkpad, _buf(pkg, 0))                # now full
    caps = core.Event.caps(core.parse_caps_string(CAPS))
    t = threading.Thread(target=lambda: (
        q.handle_sink_event(q.sinkpad, caps),
        q.handle_sink_event(q.sinkpad, core.Event.eos())))
    t.start()
    t.join(timeout=5)
    assert not t.is_alive(), "an event blocked on a full queue"
    assert q.stats["level"] == 1
    seen = []
    sink = q.srcpad.peer.element
    sink.handle_eos = lambda: seen.append("eos")
    q.start()
    deadline = time.monotonic() + 5
    while not seen and time.monotonic() < deadline:
        time.sleep(0.01)
    q.stop()
    assert got == [0] and seen == ["eos"]
    assert str(sink.sinkpad.caps).startswith("other/tensors")


@pytest.mark.parametrize("pkg", list(PKGS))
def test_backpressure_blocks_then_drains_in_order(pkg):
    q, got = _queue(pkg, max_size_buffers=2)
    t = threading.Thread(target=lambda: [q.chain(q.sinkpad, _buf(pkg, i))
                                         for i in range(5)])
    t.start()
    deadline = time.monotonic() + 5
    while q.stats["level"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)
    assert t.is_alive() and q.stats["level"] == 2   # the third push waits
    q.start()
    t.join(timeout=5)
    assert not t.is_alive()
    deadline = time.monotonic() + 5
    while len(got) < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    q.stop()
    assert got == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_stop_releases_a_blocked_producer(pkg):
    q, got = _queue(pkg, max_size_buffers=1)
    q.chain(q.sinkpad, _buf(pkg, 0))
    t = threading.Thread(target=lambda: q.chain(q.sinkpad, _buf(pkg, 1)))
    t.start()
    time.sleep(0.5)
    assert t.is_alive()                             # blocked on the full queue
    q.stop()
    t.join(timeout=5)
    assert not t.is_alive() and got == [] and q.stats["level"] == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_flush_clears_the_queue(pkg):
    core = PKGS[pkg][0]
    q, got = _queue(pkg, max_size_buffers=4)
    for i in range(3):
        q.chain(q.sinkpad, _buf(pkg, i))
    q.handle_sink_event(q.sinkpad, core.Event(core.EventType.FLUSH))
    q.chain(q.sinkpad, _buf(pkg, 9))
    assert q.stats["level"] == 1
    q.start()
    deadline = time.monotonic() + 5
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    q.stop()
    assert got == [9]


def test_pipeline_order_matches_jax():
    """appsrc ! queue ! queue ! tensor_sink: every buffer, in order, then
    EOS — in both packages."""
    line = (f"appsrc name=in caps={CAPS} ! queue max-size-buffers=2 "
            "! queue max-size-buffers=1 ! tensor_sink name=out max-stored=0")
    res = {}
    for pkg, parse in (("port", parse_launch), ("jax", jax_parse_launch)):
        pipe = parse(line)
        got = []
        pipe.get("out").connect(
            lambda b: got.append(int(np.asarray(b.tensors[0])[0])))
        pipe.play()
        try:
            for i in range(50):
                pipe.get("in").push_buffer(np.array([i, i], np.int32))
            pipe.get("in").end_of_stream()
            msg = pipe.wait(timeout=30)
        finally:
            pipe.stop()
        assert msg.type.value == "eos", (pkg, msg)
        res[pkg] = got
    assert res["port"] == res["jax"] == list(range(50))
