"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and the control (the reference one
precision step below the configuration's) fails the limits. The runs
skip the harness's look for a card and drive the rest of a run on the
CPU: full-size frames, two to a buffer, a one-second window."""
import time

import pytest
import torch

from benchmark import core
from benchmark.systems import common

CELLS = ["mobilenet_v2_bf16.nvdec_live_b16", "mobilenet_v2_int8_tflite.nvdec_b64"]
SMALL = {"frames_per_buffer": 2, "pool_buffers": 3, "warmup_buffers": 1,
         "sample_buffers": 2, "rate_frames_per_s": 8, "in_flight": 1}


def _run(name, fault=None, seed=2**31 + 11):
    cell = core.find_cell(core.load_manifest(), name)
    cell.traffic.update(SMALL)
    return core.run_cell(cell, seed, 1.0, False, time.perf_counter(), "cpu",
                         fault=fault, keep_frames=True)


def _altered(pipe):
    """One frame's answer altered where it is produced: its lowest output
    raised above its best."""
    tee = pipe.get("t")
    inner = tee._chain_guarded

    def chain(pad, buf):
        if buf.offset is not None and buf.offset >= 0:
            x = buf.tensors[0].clone()
            lo = x[0].argmin()
            x[0, lo] = x[0].max() + (x[0].max() - x[0].min()).clamp(min=2)
            buf.tensors[0] = x.to(buf.tensors[0].dtype)
        inner(pad, buf)

    tee._chain_guarded = chain


def _half_batch(fill):
    """Half of each buffer left out: its second half's outputs are not
    computed but left as ``fill`` leaves them."""

    def fault(pipe):
        tee = pipe.get("t")
        inner = tee._chain_guarded

        def chain(pad, buf):
            if buf.offset is not None and buf.offset >= 0:
                x = buf.tensors[0].clone()
                fill(x, x.shape[0] // 2)
                buf.tensors[0] = x
            inner(pad, buf)

        tee._chain_guarded = chain

    return fault


def _stale(x, h):
    """An output buffer reused: the first half's outputs again."""
    x[h:] = x[:h]


def _unwritten(x, h):
    """A fresh output buffer: zeros."""
    x[h:] = 0


def _label_altered(pipe):
    """A label altered where the decoder produces it."""
    dec = pipe.get("dec")
    inner = dec._push_decoded

    def push(out, src):
        if out is not None and src.offset is not None and src.offset >= 0:
            out.meta["label_indices"] = [(i + 1) % 1001 for i in out.meta["label_indices"]]
        inner(out, src)

    dec._push_decoded = push


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"], res["checks"]


FAULTS = {"answer_altered": _altered, "half_batch_stale": _half_batch(_stale),
          "half_batch_unwritten": _half_batch(_unwritten),
          "label_altered": _label_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_the_run_incorrect(name, fault):
    res = _run(name, FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    cell = core.find_cell(core.load_manifest(), name)
    cell.traffic.update(SMALL)
    system = core.load_system(cell.config["system"]).System(
        cell.config, cell.traffic, 2**31 + 13, torch.device("cpu"), core.ROOT)
    from benchmark.traffic import generator

    pool = generator.make_pool(cell.traffic, 2**31 + 13, "cpu")
    system.prepare(pool)
    frames = pool[:2].reshape(-1, *pool.shape[2:])
    ref = system.reference(frames)
    ctl = system.control(frames)
    got = common.numbers(system, ctl, system.labels_of(ctl, SMALL["frames_per_buffer"]),
                         ref, frames)
    limits = cell.config["limits"]
    assert any(got[k] > limits[k] for k in limits), got
