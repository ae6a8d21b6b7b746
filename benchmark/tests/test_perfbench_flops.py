"""Operation, byte and roofline arithmetic on shapes worked by hand."""
import numpy as np
import pytest

from benchmark import core, flops
from benchmark.tflite_reader import Graph, OpDef, TensorDef


def _t(shape, data=False):
    arr = np.zeros(shape, np.int8) if data else None
    return TensorDef(tuple(shape), np.int8, arr, np.ones(1, np.float32), np.zeros(1, np.int64))


def test_mobilenet_macs_by_hand():
    cfg = {"frame": [8, 8, 3], "stem_channels": 4, "bottlenecks": [[2, 4, 1, 1]],
           "head_channels": 6, "num_classes": 5}
    # stem 3x3/2: 4x4x4 outputs x 3 x 9; expand 1x1: 4x4x8 x 4;
    # depthwise 3x3: 4x4x8 x 9; project 1x1: 4x4x4 x 8; head: 4x4x6 x 4; fc 6x5
    want = 64 * 27 + 128 * 4 + 128 * 9 + 64 * 8 + 96 * 4 + 30
    assert flops.mobilenet_v2_macs(cfg) == want


def test_mobilenet_v2_is_about_300m_macs():
    cfg = core.find_cell(core.load_manifest(), "mobilenet_v2_bf16.nvdec_live_b16").config
    assert 290e6 < flops.mobilenet_v2_macs(cfg) < 310e6


def test_tflite_launches_by_hand():
    tensors = [_t((1, 4, 4, 2)), _t((3, 1, 1, 2), True), _t((3,)),
               _t((1, 4, 4, 3)), _t((1, 3, 3, 3), True), _t((3,)),
               _t((1, 2, 2, 3)), _t((2,)), _t((1, 3))]
    tensors[2].data = np.zeros(3, np.int32)
    tensors[5].data = np.zeros(3, np.int32)
    ops = [OpDef("CONV_2D", (0, 1, 2), (3,), {}),
           OpDef("DEPTHWISE_CONV_2D", (3, 4, 5), (6,), {}),
           OpDef("MEAN", (6, 7), (8,), {})]
    got = flops.tflite_launches(Graph(tensors, ops, (0,), (8,)), batch=2)
    # conv: 2x4x4x3 outputs x 2 inputs -> 192 MACs; bytes 64 in + 96 out + 6 w + 12 bias
    # mean: 2x2x2x3 = 24 adds, 24 in + 6 out bytes
    assert got["gemm"] == [(384.0, 178), (24.0, 30)]
    # depthwise: 2x2x2x3 outputs x 9 taps; 96 in + 24 out + 27 w + 12 bias
    assert got["depthwise"] == [(432.0, 159)]


def test_bound_takes_the_larger_of_bytes_and_operations():
    peak = flops.PEAKS["int8"]
    mem = (1.0, int(flops.HBM_BYTES_PER_S * 1e-3))      # 1 ms of bytes
    alu = (peak * 2e-3, 10)                              # 2 ms of operations
    assert flops.bound_s([mem, alu], peak) == pytest.approx(3e-3)


class _Sys:
    cfg = {"kernel_launches_per_forward": {"fma_gemm": 2, "depthwise_fma": 1}}
    peak = flops.PEAKS["int8"]
    flops_per_frame = 1e9

    def launches(self, batch):
        return {"gemm": [(1.0, int(flops.HBM_BYTES_PER_S * 1e-3))], "depthwise": []}


def test_roofline_reader_by_hand():
    rec = core.Record("x", 4, 1.0, system=_Sys(), trace_window=(10.0, 11.0),
                      entry={0: 10.1, 1: 10.5, 2: 10.9, 3: 12.0})
    # 3 forwards in the slice, 2 launches each, 2 ms of device time a forward
    rec.profile = {"kernels": {"fma_gemm_kernel<1>": [6, 6e-3]}, "busy_s": 0.25,
                   "window_s": 1.0}
    assert core.load_reader("fma_gemm_roofline")(rec) == pytest.approx(50.0)
    assert core.load_reader("device_idle_pct")(rec) == pytest.approx(75.0)


def test_a_short_kernel_count_fails_the_run():
    rec = core.Record("x", 4, 1.0, system=_Sys(), trace_window=(10.0, 11.0),
                      entry={k: 10.0 + k / 20 for k in range(20)})
    rec.profile = {"kernels": {"fma_gemm_kernel<1>": [6, 6e-3]}}
    with pytest.raises(RuntimeError, match="missing"):
        core.load_reader("fma_gemm_roofline")(rec)


def test_step_mfu_by_hand():
    s = _Sys()
    s.peak = 1e12
    rec = core.Record("x", 4, 1.0, system=s, trace_window=(10.0, 11.0),
                      entry={0: 9.9, 1: 10.2, 2: 10.6, 3: 11.2})
    rec.profile = {"busy_s": 0.02}
    # 2 buffers in the slice x 4 frames x 1 GFLOP over 1 TFLOP/s x 20 ms = 40%
    assert core.load_reader("step_mfu_pct.live")(rec) == pytest.approx(40.0)


def test_idle_gaps_are_named_by_the_span_over_their_middle():
    from benchmark import trace

    spans = [(0, 100, "head"), (40, 60, "decoder"), (200, 300, "push")]
    gaps = [(20, 40, 60), (50, 120, 170), (30, 210, 240)]
    got = trace.name_gaps(gaps, spans)
    assert [n for n, _ in got] == ["decoder", "no span of the harness", "push"]
    assert [g for _, g in got] == pytest.approx([20e-9, 50e-9, 30e-9])


def test_host_readers_read_before_the_profiled_slice():
    rec = core.Record("x", 4, 1.0, trace_window=(10.0, 11.0),
                      spans={"decoder": [(9.0, 0.002), (9.5, 0.004), (10.5, 0.5)]})
    assert rec.host_spans("decoder") == [0.002, 0.004]
    assert core.load_reader("decoder_host_ms")(rec) == pytest.approx(3.0)
    rec.trace_window = (0.0, 0.0)
    assert len(rec.host_spans("decoder")) == 3


def test_latency_readers_by_hand():
    due = [100.0 + 0.01 * k for k in range(20)]
    # buffer k is labelled k + 1 ms after its due time; the last never is
    done = {k: due[k] + 1e-3 * (k + 1) for k in range(19)}
    rec = core.Record("x", 16, 1.0, t0=100.0, due=due, completed=done)
    assert core.load_reader("latency_p50_ms")(rec) == pytest.approx(10.0)
    assert core.load_reader("latency_tail_p95_ms")(rec) == pytest.approx(19.0)
    rec.completed = {k: v for k, v in done.items() if k < 18}
    # two never labelled: each counts as the window and the drain after it
    assert core.load_reader("latency_tail_p95_ms")(rec) == pytest.approx(
        1e3 * (100.0 + 1.0 + core.DRAIN_S - due[19]))
    rec.completed = done
    rec.trace_window = (100.095, 100.2)
    # a traced run's tail reads the buffers due before the slice: 1..10 ms
    assert core.load_reader("latency_tail_p95_ms")(rec) == pytest.approx(10.0)
    assert core.load_reader("latency_p50_ms")(rec) == pytest.approx(10.0)
