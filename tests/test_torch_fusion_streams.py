"""Segment fusion around the stream-structure elements: the cases of
nnstreamer_tpu's ``tests/test_fusion.py`` that need ``tensor_if``,
``tensor_mux``/``tensor_demux``, the sparse codecs and the filter's
``invoke-dynamic``/``suspend``, held against the reference as
``tests/test_torch_fusion.py`` holds the others: the same segment plans
and barrier reasons, per-sink records equal fused, with ``fuse=False``
and in nnstreamer_tpu, and the same segment counters."""
import pytest
from test_torch_fusion import (ADD, MUL, SCALER, SRC, _same_plan,
                               _seg_counts, port, ref, run_probed)

LINES = {
    "tensor_if_between_segments":
        SRC + f"! {ADD}! {MUL}! tensor_if compared-value=a-value "
        "compared-value-option=0:0 operator=gt supplied-value=4 "
        f"then=passthrough else=skip ! {ADD}! {MUL}! tensor_sink name=out",
    "tensor_if_branch_pads":
        SRC + f"! {ADD}! tensor_if name=tif compared-value=a-value "
        "compared-value-option=0:0 operator=lt supplied-value=4 "
        "then=passthrough else=passthrough "
        f"tif.src_0 ! queue ! {ADD}! {MUL}! tensor_sink name=then_out "
        f"tif.src_1 ! queue ! {MUL}! {ADD}! tensor_sink name=else_out",
    "mux_fan_in":
        "tensor_mux name=m sync-mode=slowest "
        f"! {ADD}! {MUL}! tensor_sink name=out "
        "tensor_src num-buffers=4 dimensions=2 types=float32 "
        "pattern=counter ! m.sink_0 "
        "tensor_src num-buffers=4 dimensions=3 types=float32 "
        "pattern=counter ! m.sink_1",
    "demux_fan_out":
        "tensor_src num-buffers=4 dimensions=2.3.4 types=float32 "
        f"pattern=counter ! {ADD}! tensor_demux name=d "
        f"d.src_0 ! queue ! {ADD}! {MUL}! tensor_sink name=a "
        f"d.src_1 ! queue ! {MUL}! {MUL}! tensor_sink name=b",
    "flexible_stream_chain":
        "tensor_src num-buffers=5 dimensions=8 types=float32 "
        "pattern=counter ! tensor_filter framework={fw} "
        "model=builtin://scaler?factor=2 invoke-dynamic=true {acc}"
        f"! {ADD}! {MUL}! tensor_sink name=out",
    "sparse_host_sandwich":
        SRC + f"! {ADD}! {MUL}! tensor_sparse_enc ! tensor_sparse_dec "
        f"! {MUL}! {ADD}! tensor_sink name=out",
    "merge_after_two_segments":
        SRC + "! tee name=t "
        f"t. ! queue ! {ADD}! {MUL}! m.sink_0 "
        f"t. ! queue ! {MUL}! {ADD}! m.sink_1 "
        "tensor_merge name=m option=0 ! tensor_sink name=out",
}


@pytest.mark.parametrize("name", sorted(LINES))
def test_plan_matches_the_reference(name):
    _same_plan(LINES[name])


@pytest.mark.parametrize("name", sorted(LINES))
def test_byte_parity_fused_unfused_reference(name):
    line = LINES[name]
    fused_pipe, fused = run_probed(port, line, fuse=True)
    plain_pipe, plain = run_probed(port, line, fuse=False)
    ref_pipe, want = run_probed(ref, line)
    assert plain_pipe.fused_segments == []
    assert fused == plain == want
    for recs in fused.values():
        assert recs[-1] == ("event", "EOS", "")
    assert _seg_counts(fused_pipe) == _seg_counts(ref_pipe)


def test_tee_if_and_serving_are_barriers():
    segs, barriers = _same_plan(
        SRC + "! tee name=t t. ! queue ! tensor_if compared-value=a-value "
        "compared-value-option=0:0 operator=ge supplied-value=0 "
        "then=passthrough else=skip ! tensor_sink name=a "
        "t. ! queue ! tensor_serving framework={fw} "
        "model=builtin://scaler?factor=2 {acc}! tensor_sink name=b")
    reasons = " | ".join(barriers.values())
    assert "tee fan-out" in reasons
    assert "tensor_if dynamic routing" in reasons
    assert "FUSABLE=False" in reasons


@pytest.mark.parametrize("prop,key", [("invoke-dynamic=true", "invoke-dynamic"),
                                      ("suspend=100", "suspend")])
def test_filter_prop_disqualifiers_are_barriers(prop, key):
    segs, barriers = _same_plan(SRC + f"! {ADD}! {SCALER}{prop} "
                                "! tensor_sink")
    assert segs == []
    assert any(key in r for r in barriers.values())
