"""The generator: schedules and frames repeat from their seed, and the
open loop keeps its schedule when the line stalls."""
import time

import pytest
import torch

from benchmark.traffic import generator

OPEN = {"loop": "open", "frames_per_buffer": 16, "groups": 4, "phases": [0, 0.3, 0.5, 0.9],
        "rate_frames_per_s": 6400, "pool_buffers": 8}
CLOSED = {"loop": "closed", "frames_per_buffer": 64, "in_flight": 4,
          "max_buffers": 50, "pool_buffers": 8}


def test_open_schedule_repeats_from_its_seed():
    a = generator.make_schedule(OPEN, 2**31 + 7, 2.0)
    b = generator.make_schedule(OPEN, 2**31 + 7, 2.0)
    c = generator.make_schedule(OPEN, 2**31 + 8, 2.0)
    assert a.due == b.due and a.pool_index == b.pool_index
    # every seed offers the same work at the same times, in another order:
    # each of 4 groups every 10 ms for 2 s, at the phases the mix states
    assert a.due == c.due and a.pool_index != c.pool_index
    assert len(a.due) == 800
    assert a.due[:4] == pytest.approx([0.0, 0.003, 0.005, 0.009])
    assert all(0 <= d < 2.0 for d in a.due) and a.due == sorted(a.due)


def test_closed_schedule_repeats_from_its_seed():
    a = generator.make_schedule(CLOSED, 5, 1.0)
    assert a.pool_index == generator.make_schedule(CLOSED, 5, 1.0).pool_index
    assert a.in_flight == 4 and len(a.pool_index) == 50


def test_open_loop_does_not_slow_when_the_line_stalls():
    sched = generator.make_schedule(OPEN, 3, 0.3)
    seen = []

    def push(seq, idx):
        seen.append((seq, time.perf_counter()))
        if seq == 5:
            time.sleep(0.1)   # the line stalls on one buffer

    d = generator.Driver(sched, push)
    t0 = time.perf_counter() + 0.01
    d.start(t0, 0.3)
    assert d.finish(5.0)
    assert [s for s, _ in seen] == list(range(len(sched.due)))
    # after the stall the backlog is offered at once, each due time kept
    late = [t - (t0 + sched.due[s]) for s, t in seen]
    assert max(late[6:12]) > 0.05
    assert late[-1] < 0.02
    assert all(t >= t0 + sched.due[s] for s, t in seen)


def test_closed_loop_waits_for_its_answers():
    sched = generator.make_schedule(CLOSED, 3, 1.0)
    pushed = []
    d = generator.Driver(sched, lambda seq, idx: pushed.append(seq))
    d.start(time.perf_counter(), 0.3)
    time.sleep(0.1)
    assert pushed == [0, 1, 2, 3]
    d.done(0)
    time.sleep(0.1)
    assert pushed == [0, 1, 2, 3, 4]
    d.abort()


def test_frames_repeat_from_their_seed():
    mix = {"frame": [16, 16, 3], "pool_buffers": 2, "frames_per_buffer": 3,
           "content": "smooth", "coarse_grid": 4, "noise": 0.05}
    a = generator.make_pool(mix, 11, "cpu")
    assert a.shape == (2, 3, 16, 16, 3) and a.dtype == torch.uint8
    assert torch.equal(a, generator.make_pool(mix, 11, "cpu"))
    assert not torch.equal(a, generator.make_pool(mix, 12, "cpu"))
    flat = a.reshape(6, -1)
    assert len({tuple(f.tolist()) for f in flat}) == 6
