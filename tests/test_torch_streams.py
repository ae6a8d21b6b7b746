"""The stream-structure elements (tensor_mux/demux/merge/split/if/crop/
rate/repo, join, tensor_debug, the sparse codecs): the port against
nnstreamer_tpu.

Every launch line runs through both packages — nnstreamer_tpu on JAX-CPU,
the port with ``accelerator=cpu`` on its filters — and compared exactly,
per sink: every buffer's tensors as (dtype, shape, raw bytes), and the
events in order with their caps strings, EOS last. The one tolerance is
tensor_if's total/average reduce, where nnstreamer_tpu reduces a device
(JAX) array in float32 and the port a host tensor in float64: the two
values agree within 1e-6 relative. The element tables (property names and
defaults) are held against the reference's too."""
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import MessageType as JMessageType
from nnstreamer_tpu.elements import cond as jcond
from nnstreamer_tpu.elements.repo import REPO as JREPO
from nnstreamer_tpu.registry.elements import _FACTORIES as J_FACTORIES
from nnstreamer_tpu.registry.elements import element_factories as j_factories
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import Buffer, MessageType
from nnstreamer_tpu_torch.elements import cond as tcond
from nnstreamer_tpu_torch.elements.repo import REPO
from nnstreamer_tpu_torch.registry.elements import _FACTORIES
from nnstreamer_tpu_torch.registry.elements import element_factories
from nnstreamer_tpu_torch.runtime.parse import parse_launch

SLICE_ELEMENTS = (
    "tensor_mux", "tensor_demux", "tensor_merge", "tensor_split",
    "tensor_if", "tensor_crop", "tensor_rate", "tensor_repo_sink",
    "tensor_repo_src", "tensor_reposink", "tensor_reposrc", "fakesink",
    "filesink", "multifilesink", "filesrc", "multifilesrc", "imagedec",
    "pngdec", "pnmdec", "tensor_src_callable", "join", "tensor_debug",
    "tensor_sparse_enc", "tensor_sparse_dec")


def _port_line(line):
    return line.format(fw="torch", acc="accelerator=cpu ")


def _ref_line(line):
    return line.format(fw="jax", acc="")


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy()
    return np.asarray(t)


def _tensor_rec(t):
    a = np.ascontiguousarray(_host(t))
    return (a.dtype.name, a.shape, a.tobytes())


def probe_sinks(pipe):
    """Per-sink records: buffers as (dtype, shape, bytes) per tensor,
    events by type (CAPS with its caps string)."""
    records = {}
    for el in pipe.sinks:
        seq = records[el.name] = []

        def render(buf, _seq=seq, _el=el):
            _seq.append(("buf", tuple(_tensor_rec(t) for t in buf.tensors)))
            type(_el).render(_el, buf)

        def hse(pad, event, _seq=seq, _el=el):
            caps = event.data.get("caps") if event.data else None
            _seq.append(("event", event.type.name,
                         str(caps) if caps is not None else ""))
            type(_el).handle_sink_event(_el, pad, event)

        el.render = render
        el.handle_sink_event = hse
    return records


def run_both(line, timeout=60.0):
    """(port records, reference records, port pipe, reference pipe)."""
    out = []
    for parse, fmt in ((parse_launch, _port_line),
                       (jax_parse_launch, _ref_line)):
        pipe = parse(fmt(line))
        records = probe_sinks(pipe)
        pipe.run(timeout=timeout)
        out.append((records, pipe))
    (got, ppipe), (want, rpipe) = out
    return got, want, ppipe, rpipe


def _bufs(records, sink):
    return [r[1] for r in records[sink] if r[0] == "buf"]


def _value(rec):
    """First element of a buffer record's first tensor, as a float."""
    dt, shape, raw = rec[0]
    return float(np.frombuffer(raw, dt)[0])


SRC = "tensor_src num-buffers={n} dimensions={d} types={t} pattern={p} "

LINES = {
    "mux_slowest":
        "tensor_mux name=m sync-mode=slowest ! tensor_sink name=out "
        "tensor_src num-buffers=3 dimensions=2 types=float32 ! m.sink_0 "
        "tensor_src num-buffers=3 dimensions=3 types=uint8 ! m.sink_1",
    "mux_nosync_three_pads":
        "tensor_mux name=m sync-mode=nosync ! tensor_sink name=out "
        "tensor_src num-buffers=4 dimensions=2 types=float32 ! m.sink_0 "
        "tensor_src num-buffers=4 dimensions=3 types=int16 ! m.sink_1 "
        "tensor_src num-buffers=4 dimensions=2:2 types=uint8 ! m.sink_2",
    "demux_pick":
        "tensor_src num-buffers=2 dimensions=2.3.4 types=float32 ! "
        "tensor_demux name=d tensorpick=2,0 "
        "d.src_0 ! tensor_sink name=a  d.src_1 ! tensor_sink name=b",
    "demux_pick_groups":
        "tensor_src num-buffers=2 dimensions=2.3.4 types=float32 "
        "pattern=counter ! tensor_demux name=d tensorpick=0:1,2 "
        "d.src_0 ! tensor_sink name=a  d.src_1 ! tensor_sink name=b",
    "demux_default_order":
        "tensor_src num-buffers=2 dimensions=2.3 types=int32 ! "
        "tensor_demux name=d d.src_0 ! tensor_sink name=a "
        "d.src_1 ! tensor_sink name=b",
    "mux_then_demux":
        "tensor_mux name=m ! tensor_demux name=d tensorpick=1,0 "
        "d.src_0 ! tensor_sink name=a d.src_1 ! tensor_sink name=b "
        "tensor_src num-buffers=3 dimensions=4 types=float32 "
        "pattern=counter ! m.sink_0 "
        "tensor_src num-buffers=3 dimensions=2:2 types=uint8 "
        "pattern=random seed=4 ! m.sink_1",
    "merge_axis0":
        "tensor_merge name=m option=0 ! tensor_sink name=out "
        "tensor_src num-buffers=2 dimensions=3:2 types=float32 pattern=ones ! m.sink_0 "
        "tensor_src num-buffers=2 dimensions=3:4 types=float32 pattern=zeros ! m.sink_1",
    "merge_axis1_counter":
        "tensor_merge name=m mode=linear option=1 ! tensor_sink name=out "
        "tensor_src num-buffers=3 dimensions=2:3 types=int32 pattern=counter ! m.sink_0 "
        "tensor_src num-buffers=3 dimensions=5:3 types=int32 pattern=counter ! m.sink_1",
    "merge_then_split":
        "tensor_src num-buffers=3 dimensions=3:4:4:2 types=uint8 "
        "pattern=random seed=7 ! tee name=t "
        "t. ! queue ! m.sink_0 t. ! queue ! m.sink_1 "
        "tensor_merge name=m mode=linear option=0 ! tensor_split name=s "
        "axis=0 tensorseg=2,2 s.src_0 ! tensor_sink name=a "
        "s.src_1 ! tensor_sink name=b",
    "split_even":
        "tensor_src num-buffers=1 dimensions=2:4 types=float32 pattern=counter ! "
        "tensor_split name=s axis=0 "
        "s.src_0 ! tensor_sink name=a  s.src_1 ! tensor_sink name=b",
    "split_segments":
        "tensor_src num-buffers=1 dimensions=1:6 types=float32 ! "
        "tensor_split name=s axis=0 tensorseg=2,4 "
        "s.src_0 ! tensor_sink name=a  s.src_1 ! tensor_sink name=b",
    "split_tensorpick_axis1":
        "tensor_src num-buffers=2 dimensions=6:2 types=int16 "
        "pattern=random seed=2 ! tensor_split name=s axis=1 "
        "tensorseg=1,2,3 tensorpick=2,0 "
        "s.src_0 ! tensor_sink name=a  s.src_1 ! tensor_sink name=b",
    "if_average_gate":
        "tensor_src num-buffers=5 dimensions=4 types=float32 pattern=counter "
        "! tensor_if compared-value=tensor-average-value compared-value-option=0 "
        "operator=gt supplied-value=2 then=passthrough else=skip "
        "! tensor_sink name=out",
    "if_total_range":
        "tensor_src num-buffers=6 dimensions=4 types=int32 pattern=counter "
        "! tensor_if compared-value=tensor-total-value "
        "compared-value-option=0 operator=range-inclusive "
        "supplied-value=4:12 then=passthrough else=fill-zero "
        "! tensor_sink name=out",
    "if_fill_zero_else":
        "tensor_src num-buffers=3 dimensions=2 types=float32 pattern=counter "
        "! tensor_if compared-value=a-value compared-value-option=0:0 "
        "operator=ge supplied-value=1 then=passthrough else=fill-zero "
        "! tensor_sink name=out",
    "if_fill_values":
        "tensor_src num-buffers=4 dimensions=3 types=int16 pattern=counter "
        "! tensor_if compared-value=a-value compared-value-option=0:1 "
        "operator=ne supplied-value=2 then=fill-values then-option=7 "
        "else=passthrough ! tensor_sink name=out",
    "if_repeat_previous":
        "tensor_src num-buffers=5 dimensions=2 types=float32 pattern=counter "
        "! tensor_if compared-value=a-value operator=lt supplied-value=2 "
        "then=passthrough else=repeat-previous ! tensor_sink name=out",
    "if_random_uint8_lt":
        "tensor_src num-buffers=8 dimensions=3:4:4:2 types=uint8 "
        "pattern=random seed=11 ! tensor_if compared-value=a-value "
        "compared-value-option=0:5 operator=lt supplied-value=64 "
        "then=passthrough else=skip ! tensor_sink name=out",
    "if_branch_src_pads":
        "tensor_src num-buffers=4 dimensions=2 types=float32 pattern=counter "
        "! tensor_if name=tif compared-value=a-value compared-value-option=0:0 "
        "operator=lt supplied-value=2 then=passthrough else=passthrough "
        "tif.src_0 ! queue ! tensor_sink name=then_out "
        "tif.src_1 ! queue ! tensor_sink name=else_out",
    "if_branch_pads_tensorpick":
        "tensor_src num-buffers=4 dimensions=2 types=float32 pattern=counter ! m.sink_0 "
        "tensor_src num-buffers=4 dimensions=4 types=float32 pattern=counter ! m.sink_1 "
        "tensor_mux name=m sync-mode=nosync ! tensor_if name=tif "
        "compared-value=a-value compared-value-option=0:0 "
        "operator=lt supplied-value=2 "
        "then=tensorpick then-option=0 else=tensorpick else-option=1 "
        "tif.src_0 ! queue ! tensor_sink name=then_out "
        "tif.src_1 ! queue ! tensor_sink name=else_out",
    "if_tensorpick_caps_into_filter":
        "tensor_src num-buffers=2 dimensions=2.5 types=float32 pattern=ones "
        "! tensor_if compared-value=a-value compared-value-option=0:0 "
        "operator=ge supplied-value=0 then=tensorpick then-option=1 else=skip "
        "! tensor_filter framework={fw} model=builtin://scaler?factor=4 {acc}"
        "! tensor_sink name=out",
    "if_tee_two_filters_mux_demux":
        "tensor_src num-buffers=6 dimensions=3:4:4:2 types=uint8 "
        "pattern=random seed=5 ! tensor_if compared-value=a-value "
        "compared-value-option=0:0 operator=lt supplied-value=64 "
        "then=passthrough else=skip ! tee name=t "
        "t. ! queue ! tensor_filter framework={fw} "
        "model=builtin://scaler?factor=2 {acc}! mux.sink_0 "
        "t. ! queue ! tensor_filter framework={fw} "
        "model=builtin://add?value=3 {acc}! mux.sink_1 "
        "tensor_mux name=mux ! tensor_demux name=d tensorpick=0,1 "
        "d.src_0 ! tensor_sink name=a d.src_1 ! tensor_sink name=b",
    "join_branches":
        "tensor_src num-buffers=4 dimensions=1 types=float32 pattern=counter "
        "! tensor_if compared-value=a-value compared-value-option=0:0 operator=lt "
        "supplied-value=2 then=passthrough else=skip ! j.sink_0 "
        "join name=j ! tensor_sink name=out",
    "join_if_pads":
        "tensor_src num-buffers=5 dimensions=2 types=int32 pattern=counter "
        "! tensor_if name=tif compared-value=a-value operator=lt "
        "supplied-value=3 then=passthrough else=fill-zero "
        "tif.src_0 ! j.sink_0 tif.src_1 ! j.sink_1 "
        "join name=j ! tensor_sink name=out",
    "debug_passthrough":
        "tensor_src num-buffers=2 dimensions=2 ! tensor_debug ! tensor_sink name=out",
    "debug_console_modes":
        "tensor_src num-buffers=2 dimensions=3:2 types=uint8 pattern=counter "
        "! tensor_debug output-method=none capability=0 metadata=1 "
        "! tensor_sink name=out",
    "sparse_roundtrip_counter":
        "tensor_src num-buffers=3 dimensions=4:2 types=float32 "
        "pattern=counter ! tensor_sparse_enc ! tensor_sparse_dec "
        "! tensor_sink name=out",
    "rate_paced":
        "tensor_src num-buffers=12 dimensions=1 framerate=200 "
        "pattern=counter ! tensor_rate name=r framerate=50 "
        "! tensor_sink name=out",
}


@pytest.mark.parametrize("name", sorted(LINES))
def test_line_matches_the_reference(name):
    got, want, _, _ = run_both(LINES[name])
    assert got == want
    for recs in got.values():
        assert recs[-1] == ("event", "EOS", "")
    assert any(r[0] == "buf" for recs in got.values() for r in recs)


@pytest.mark.parametrize("op,supplied", [
    ("eq", "2"), ("ne", "2"), ("gt", "2"), ("ge", "2"), ("lt", "2"),
    ("le", "2"), ("range-inclusive", "1:3"), ("range-exclusive", "1:3"),
    ("not-in-range-inclusive", "1:3"), ("not-in-range-exclusive", "1:3")])
def test_if_operators_route_like_the_reference(op, supplied):
    line = ("tensor_src num-buffers=5 dimensions=2 types=float32 "
            "pattern=counter ! tensor_if name=tif compared-value=a-value "
            f"operator={op} supplied-value={supplied} then=passthrough "
            "else=passthrough tif.src_0 ! queue ! tensor_sink name=then_out "
            "tif.src_1 ! queue ! tensor_sink name=else_out")
    got, want, _, _ = run_both(line)
    assert got == want
    assert len(_bufs(got, "then_out")) + len(_bufs(got, "else_out")) == 5


def test_rate_counters_and_throttle_match():
    got, want, ppipe, rpipe = run_both(LINES["rate_paced"])
    pr, rr = ppipe.get("r"), rpipe.get("r")
    for key in ("in", "out", "drop", "duplicate"):
        assert pr.get_property(key) == rr.get_property(key)
    assert pr.get_property("in") == 12
    line = ("tensor_src num-buffers=10 dimensions=2 framerate=0 "
            "! tensor_filter framework={fw} model=builtin://passthrough "
            "{acc}name=f ! tensor_rate framerate=10 throttle=true "
            "! tensor_sink name=out")
    _, _, ppipe, rpipe = run_both(line)
    assert ppipe.get("f")._throttle_delay_s == pytest.approx(0.1)
    assert rpipe.get("f")._throttle_delay_s == pytest.approx(0.1)


def test_conflicting_branch_selections_error_like_the_reference():
    line = ("tensor_src num-buffers=1 dimensions=2.5 types=float32 "
            "! tensor_if name=tif compared-value=a-value "
            "compared-value-option=0:0 operator=ge supplied-value=0 "
            "then=tensorpick then-option=1 else=passthrough "
            "! tensor_sink name=out")
    errors = []
    for parse, mt in ((parse_launch, MessageType),
                      (jax_parse_launch, JMessageType)):
        pipe = parse(line)
        pipe.play()
        msg = pipe.bus.wait_for((mt.ERROR,), timeout=5)
        pipe.stop()
        assert msg is not None
        errors.append(msg.data["error"].split(": ", 1)[1])
    assert errors[0] == errors[1]
    assert "tensor selections" in errors[0]


def test_custom_condition_like_the_reference():
    line = ("tensor_src num-buffers=4 dimensions=1 types=float32 "
            "pattern=counter ! tensor_if compared-value=custom "
            "compared-value-option=even then=passthrough else=skip "
            "! tensor_sink name=out")
    tcond.register_if_condition("even", lambda b: b.offset % 2 == 0)
    jcond.register_if_condition("even", lambda b: b.offset % 2 == 0)
    try:
        got, want, _, _ = run_both(line)
    finally:
        assert tcond.unregister_if_condition("even")
        assert jcond.unregister_if_condition("even")
    assert got == want
    assert len(_bufs(got, "out")) == 2
    assert not tcond.unregister_if_condition("even")


@pytest.mark.parametrize("kind", ["tensor-total-value",
                                  "tensor-average-value"])
def test_if_reduce_on_filter_output_matches_within_1e6(kind):
    """After a filter, nnstreamer_tpu's buffer is a device (JAX) array and
    reduces in float32; the port's CPU tensor reduces in float64. The
    values agree within 1e-6 relative and route the same way."""
    rng = np.random.default_rng(3)
    frames = [rng.standard_normal((8, 16)).astype(np.float32)
              for _ in range(4)]
    line = ("appsrc name=in caps=other/tensors,format=static,"
            "dimensions=16:8,types=float32 ! tensor_filter framework={fw} "
            "model=builtin://scaler?factor=3 {acc}! tensor_if name=tif "
            f"compared-value={kind} compared-value-option=0 operator=gt "
            "supplied-value=0 then=passthrough else=skip ! tensor_sink "
            "name=out")
    got = {}
    for parse, fmt, buf_cls in ((parse_launch, _port_line, Buffer),
                                (jax_parse_launch, _ref_line, JBuffer)):
        pipe = parse(fmt(line))
        seen = []
        tif = pipe.get("tif")
        orig = tif._compared_value

        def spy(buf, _orig=orig, _seen=seen):
            v = _orig(buf)
            _seen.append(v)
            return v
        tif._compared_value = spy
        records = probe_sinks(pipe)
        pipe.play()
        for f in frames:
            pipe.get("in").push_buffer(buf_cls([f]))
        pipe.get("in").end_of_stream()
        pipe.wait(timeout=60)
        pipe.stop()
        got[parse] = (seen, records)
    (pvals, precs), (rvals, rrecs) = got[parse_launch], got[jax_parse_launch]
    assert precs == rrecs
    assert [a for _, a in pvals] == [False] * 4   # host: exact float64
    assert [a for _, a in rvals] == [True] * 4    # device: float32
    for (pv, _), (rv, _), f in zip(pvals, rvals, frames):
        exact = float((f * np.float32(3)).astype(np.float64).sum())
        if kind == "tensor-average-value":
            exact /= f.size
        assert pv == pytest.approx(exact, rel=1e-12)
        assert pv == pytest.approx(rv, rel=1e-6)


def test_if_device_eq_tolerance_constant_matches():
    assert tcond.TensorIf._DEVICE_EQ_RTOL == jcond.TensorIf._DEVICE_EQ_RTOL \
        == 1e-6


def _crop_run(parse, buf_cls, lateness=""):
    pipe = parse(
        f"tensor_crop name=c {lateness}! tensor_sink name=out "
        "videotestsrc num-buffers=2 width=16 height=16 format=RGB "
        "pattern=gradient ! tensor_converter ! c.raw "
        "appsrc name=regions caps=other/tensors,format=static,"
        "dimensions=4:2,types=int32 ! c.info")
    records = probe_sinks(pipe)
    pipe.play()
    for _ in range(2):
        pipe.get("regions").push_buffer(buf_cls(
            [np.array([[0, 0, 4, 8], [2, 2, 6, 6]], np.int32)], pts=0.0))
    pipe.get("regions").end_of_stream()
    pipe.wait(timeout=20)
    pipe.stop()
    return records


@pytest.mark.parametrize("lateness", ["", "lateness=-1 "])
def test_crop_regions_like_the_reference(lateness):
    got = _crop_run(parse_launch, Buffer, lateness)
    want = _crop_run(jax_parse_launch, JBuffer, lateness)
    assert got == want
    (first, _) = _bufs(got, "out")
    assert [rec[1] for rec in first] == [(1, 8, 4, 3), (1, 6, 6, 3)]


def test_crop_is_a_host_barrier_like_the_reference():
    from nnstreamer_tpu.elements.crop import TensorCrop as JCrop
    from nnstreamer_tpu_torch.elements.crop import TensorCrop

    assert TensorCrop.DEVICE_AFFINITY == JCrop.DEVICE_AFFINITY == "host"
    assert TensorCrop.FUSION_BARRIER == JCrop.FUSION_BARRIER
    assert [t.name_template for t in TensorCrop.SINK_TEMPLATES] == \
        ["raw", "info"]


@pytest.mark.parametrize("sink_name", ["tensor_repo_sink", "tensor_reposink"])
def test_repo_feedback_slot_like_the_reference(sink_name):
    src_name = sink_name.replace("sink", "src")
    results = []
    for parse, repo in ((parse_launch, REPO), (jax_parse_launch, JREPO)):
        repo.reset()
        parse("tensor_src num-buffers=3 dimensions=2 types=float32 "
              f"pattern=counter ! {sink_name} slot-index=7").run(timeout=10)
        p2 = parse(f"{src_name} slot-index=7 initial-dummy=true "
                   "caps=other/tensors,format=static,dimensions=2,"
                   "types=float32 ! tensor_sink name=out")
        records = probe_sinks(p2)
        p2.play()
        p2.wait(timeout=10)
        p2.stop()
        results.append(records)
    assert results[0] == results[1]
    vals = [_value(b) for b in _bufs(results[0], "out")]
    assert vals == [0.0, 1.0, 2.0]  # dummy zeros, then the slot's last 2


def test_repo_negative_slot_refused_like_the_reference():
    from nnstreamer_tpu.runtime.element import ElementError as JError
    from nnstreamer_tpu_torch.runtime.element import ElementError

    with pytest.raises(ElementError, match="must be >= 0"):
        parse_launch("tensor_src ! tensor_repo_sink slot-index=-1")
    with pytest.raises(JError, match="must be >= 0"):
        jax_parse_launch("tensor_src ! tensor_repo_sink slot-index=-1")


def _appsrc_run(parse, buf_cls, line, frames):
    pipe = parse(line)
    records = probe_sinks(pipe)
    pipe.play()
    for f in frames:
        pipe.get("in").push_buffer(buf_cls([f]))
    pipe.get("in").end_of_stream()
    pipe.wait(timeout=20)
    pipe.stop()
    return records


def test_sparse_codecs_like_the_reference():
    dense = np.zeros((4, 2), np.float32)
    dense[0, 1] = 5.0
    dense[3, 0] = -2.0
    for tail in ("! tensor_sparse_dec ! tensor_sink name=out",
                 "! tensor_sink name=out"):
        line = ("appsrc name=in caps=other/tensors,format=static,"
                f"dimensions=2:4,types=float32 ! tensor_sparse_enc {tail}")
        got = _appsrc_run(parse_launch, Buffer, line, [dense])
        want = _appsrc_run(jax_parse_launch, JBuffer, line, [dense])
        assert got == want
    got = _appsrc_run(parse_launch, Buffer, line.replace(
        "! tensor_sink", "! tensor_sparse_dec ! tensor_sink"), [dense])
    (rec,) = _bufs(got, "out")
    assert rec[0][2] == dense.tobytes()


class TestMuxBasepadOption:
    """sync-option for basepad (reference 'sink_id[:duration]'), held
    against nnstreamer_tpu's run of the same pushes."""

    LINE = ("tensor_mux name=mux sync-mode=basepad {opt} "
            "! tensor_sink name=out max-stored=32 "
            "appsrc name=a caps=other/tensors,format=static,dimensions=1,"
            "types=float32 ! mux.sink_0 "
            "appsrc name=b caps=other/tensors,format=static,dimensions=1,"
            "types=float32 ! mux.sink_1 ")

    @staticmethod
    def _settle(predicate, timeout=5.0):
        deadline = time.monotonic() + timeout
        while not predicate() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert predicate()

    def _run(self, parse, buf_cls, opt, pushes):
        pipe = parse(self.LINE.format(opt=opt))
        records = probe_sinks(pipe)
        got = []
        pipe.get("out").connect(got.append)
        pipe.play()
        mux = pipe.get("mux")
        for pad, val, pts, settle in pushes:
            pipe.get(pad).push_buffer(
                buf_cls([np.array([val], np.float32)], pts=pts))
            if settle == "latest":
                other = "sink_0" if pad == "a" else "sink_1"
                self._settle(lambda: other in mux._latest)
            elif settle is not None:
                self._settle(lambda n=settle: len(got) == n)
        pipe.get("a").end_of_stream()
        pipe.get("b").end_of_stream()
        pipe.wait(timeout=10)
        pipe.stop()
        return records

    def _both(self, opt, pushes):
        got = self._run(parse_launch, Buffer, opt, pushes)
        want = self._run(jax_parse_launch, JBuffer, opt, pushes)
        assert got == want
        return _bufs(got, "out")

    def test_base_pad_selectable(self):
        bufs = self._both("sync-option=1", [
            ("a", 0.0, 0.0, "latest"), ("b", 10.0, 0.0, 1),
            ("b", 11.0, 0.1, None)])
        assert len(bufs) == 2
        assert [float(np.frombuffer(b[1][2], np.float32)[0])
                for b in bufs] == [10.0, 11.0]

    def test_max_gap_skips_stale_companion(self):
        bufs = self._both("sync-option=0:0.5", [
            ("b", 1.0, 0.0, "latest"), ("a", 0.0, 0.1, 1),
            ("a", 2.0, 5.0, None)])
        assert len(bufs) == 1


def test_tensor_src_callable_like_the_reference():
    def sampler(i):
        return np.full((2, 3), i, np.int16) if i < 3 else None

    recs = []
    for parse in (parse_launch, jax_parse_launch):
        pipe = parse("tensor_src_callable name=s dimensions=3:2 "
                     "types=int16 ! tensor_sink name=out")
        pipe.get("s").sampler = sampler
        records = probe_sinks(pipe)
        pipe.run(timeout=10)
        recs.append(records)
    assert recs[0] == recs[1]
    assert [_value(b) for b in _bufs(recs[0], "out")] == [0.0, 1.0, 2.0]


def test_tensor_src_callable_keeps_torch_tensors():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    pipe = parse_launch("tensor_src_callable name=s dimensions=3:2 "
                        "num-buffers=1 ! tensor_sink name=out")
    pipe.get("s").sampler = lambda i: t
    got = []
    pipe.get("out").connect(got.append)
    pipe.run(timeout=10)
    assert got[0].tensors[0] is t


def test_registry_holds_the_slice_elements():
    names = set(element_factories())
    assert set(SLICE_ELEMENTS) <= names
    assert set(SLICE_ELEMENTS) <= set(j_factories())


def _table(cls):
    merged = {}
    for klass in reversed(cls.__mro__):
        merged.update(getattr(klass, "PROPERTIES", {}) or {})
    return {k: p.default for k, p in merged.items()}


@pytest.mark.parametrize("name", SLICE_ELEMENTS + ("tensor_filter",))
def test_property_names_and_defaults_match_the_reference(name):
    port_cls, ref_cls = _FACTORIES[name], J_FACTORIES[name]
    assert _table(port_cls) == _table(ref_cls)
    assert getattr(port_cls, "PROP_ALIASES", {}) == \
        getattr(ref_cls, "PROP_ALIASES", {})
    assert [(t.name_template, t.direction.name, t.presence.name)
            for t in port_cls.SINK_TEMPLATES + port_cls.SRC_TEMPLATES] == \
        [(t.name_template, t.direction.name, t.presence.name)
         for t in ref_cls.SINK_TEMPLATES + ref_cls.SRC_TEMPLATES]
    assert port_cls.FUSION_BARRIER == ref_cls.FUSION_BARRIER
    assert port_cls.DEVICE_AFFINITY == ref_cls.DEVICE_AFFINITY
