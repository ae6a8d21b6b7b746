"""The one traffic generator: camera frames and when they are offered.

A mix is a JSON file beside this one, read by name. Its parameters:

- ``frames_per_buffer``: frames in one buffer, as a muxer batches them.
- ``frame``: [height, width, channels] of one uint8 frame.
- ``pool_buffers``: distinct buffers made at set-up; the window cycles
  through them in an order drawn from the seed.
- ``content``: ``smooth``: a coarse random image per frame
  (``coarse_grid`` cells a side, bilinear) plus normal noise of deviation
  ``noise`` on the [0, 1] scale, as decoded camera frames are: smooth
  regions and sensor noise.
- ``loop``: ``open`` or ``closed``.
  - open: ``groups`` groups of cameras, each offering one buffer every
    ``groups * frames_per_buffer / rate_frames_per_s`` seconds, group
    ``g`` at the phase ``phases[g]`` (a share of that period); nothing
    waits for the system. The phases are data, not drawn from the seed:
    how often two groups' buffers meet sets the queueing, so a seeded
    phase would change the work from seed to seed.
  - closed: ``in_flight`` buffers outstanding; the next is offered when
    one has been labelled.
- ``branch_queues``: whether the decoder and the outputs' sink behind
  the filter's ``tee`` run on threads of their own (``queue``s) or on
  the filter's.
- ``warmup_buffers``: buffers pushed and labelled before the window.
- ``sample_buffers``: buffers of the window whose outputs are checked.
- ``trace_seconds``: the window's last seconds, which the profiler
  records in a traced run.

The frames are made on the device from the seed, in a few large calls;
the same seed gives the same frames and the same order, and every seed
the same due times.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# frames are made in chunks of this many to bound the float32 temporaries
_CHUNK = 128


def make_pool(params: dict, seed: int, device) -> torch.Tensor:
    """(pool_buffers, frames_per_buffer, H, W, C) uint8 on ``device``."""
    h, w, c = params["frame"]
    n_buf, per = params["pool_buffers"], params["frames_per_buffer"]
    n = n_buf * per
    if params["content"] != "smooth":
        raise ValueError(f"traffic: content {params['content']!r} is not 'smooth'")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    g = params["coarse_grid"]
    out = torch.empty((n, h, w, c), dtype=torch.uint8, device=device)
    for i in range(0, n, _CHUNK):
        k = min(_CHUNK, n - i)
        coarse = torch.rand((k, c, g, g), generator=gen, device=device)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                            align_corners=False)
        img += params["noise"] * torch.randn((k, c, h, w), generator=gen,
                                              device=device)
        out[i:i + k] = (img.clamp_(0, 1) * 255).round_().to(torch.uint8) \
            .permute(0, 2, 3, 1)
    return out.view(n_buf, per, h, w, c)


@dataclass
class Schedule:
    """The window's buffers: due time (seconds from the window's start,
    open loop) and the pool buffer each carries."""

    loop: str
    due: List[float]
    pool_index: List[int]
    in_flight: int = 0


def make_schedule(params: dict, seed: int, seconds: float) -> Schedule:
    """The window's arrivals. An open loop lists every buffer due in
    ``seconds``; a closed loop lists pool indices for more buffers than
    the window can take (the driver stops at the window's end)."""
    rng = np.random.default_rng([seed, 0x7261])
    n_pool = params["pool_buffers"]
    if params["loop"] == "open":
        groups = params["groups"]
        period = groups * params["frames_per_buffer"] / params["rate_frames_per_s"]
        phases = [f * period for f in params["phases"]]
        if len(phases) != groups:
            raise ValueError(f"traffic: {len(phases)} phases for {groups} groups")
        due = sorted(float(p + k * period) for p in phases
                     for k in range(int(seconds / period) + 1)
                     if p + k * period < seconds)
        order = rng.permutation(max(len(due), 1))
        return Schedule("open", due, [int(i % n_pool) for i in order[:len(due)]])
    if params["loop"] == "closed":
        n = params["max_buffers"]
        order = rng.integers(0, n_pool, n)
        return Schedule("closed", [], [int(i) for i in order], params["in_flight"])
    raise ValueError(f"traffic: loop {params['loop']!r} is not open or closed")


@dataclass
class Driver:
    """Offers the window's buffers through ``push(seq, pool_index)``. The
    open loop sleeps until each due time and never waits for the system;
    a buffer it could not offer on time is offered late, never skipped,
    so every buffer due in the window is offered (``finish`` waits for
    the last). The closed loop waits for ``done(seq)`` before it offers
    the next, and stops at the window's end (``finish``)."""

    schedule: Schedule
    push: Callable[[int, int], None]
    pushed: List[float] = field(default_factory=list)
    _slots: Optional[threading.Semaphore] = None
    _abort: threading.Event = field(default_factory=threading.Event)
    _thread: Optional[threading.Thread] = None
    t0: float = 0.0
    end: float = 0.0

    def start(self, t0: float, seconds: float) -> None:
        self.t0, self.end = t0, t0 + seconds
        if self.schedule.loop == "closed":
            self._slots = threading.Semaphore(self.schedule.in_flight)
        self._thread = threading.Thread(target=self._run, name="traffic",
                                        daemon=True)
        self._thread.start()

    def done(self, seq: int) -> None:
        if self._slots is not None:
            self._slots.release()

    def _run(self) -> None:
        s = self.schedule
        if s.loop == "open":
            for seq, (due, idx) in enumerate(zip(s.due, s.pool_index)):
                at = self.t0 + due
                while True:
                    left = at - time.perf_counter()
                    if left <= 0 or self._abort.is_set():
                        break
                    time.sleep(min(left, 0.05))
                if self._abort.is_set():
                    return
                self.pushed.append(time.perf_counter())
                self.push(seq, idx)
            return
        for seq, idx in enumerate(s.pool_index):
            while not self._slots.acquire(timeout=0.05):
                if self._abort.is_set() or time.perf_counter() >= self.end:
                    return
            now = time.perf_counter()
            if self._abort.is_set() or now >= self.end:
                return
            self.pushed.append(now)
            self.push(seq, idx)

    def finish(self, timeout: float) -> bool:
        """Wait until every buffer of the window has been offered; False
        if the generator is still offering after ``timeout``."""
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def abort(self) -> None:
        self._abort.set()
        self.finish(5.0)
