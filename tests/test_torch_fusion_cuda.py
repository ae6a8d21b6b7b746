"""Fused segments and pinned staging on the card (marker ``cuda``; skips
without a card). This file needs neither JAX nor nnstreamer_tpu, so it
runs where they are not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_fusion_cuda.py

* one CUDA graph per input signature: a second signature captures once
  more, a signature seen before replays;
* every output is cloned out of the graph's pool: the buffers a
  ``tensor_sink max-stored=`` keeps stay distinct, byte-equal to the
  unfused run's (without the clone they would all read the last replay);
* a capture in thread-local mode while another pipeline launches on the
  same card from its own threads: both runs complete, bytes equal;
* the stager: host frames reach the card intact, their copy finishes on
  the side stream while the caller's stream is still busy (overlap), and
  ``retarget`` drops the slots;
* a capture that fails (a model that declares itself safe to capture
  but syncs with the host) ends in a bus ERROR, with no eager fallback,
  and leaves the card's random number generator usable;
* a model that declares nothing runs its eager invoke under the default
  ``fuse``: the segment defuses, as for a pinned filter."""
import sys
import time
import types

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.core import Buffer, MessageType
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.transport.staging import DoubleBufferedStager

CHAIN = ("tensor_src device=true num-buffers={n} dimensions=16:4 "
         "types=float32 pattern={pattern} ! tensor_transform "
         "mode=arithmetic option=add:1 ! tensor_transform mode=arithmetic "
         "option=mul:3 ! tensor_filter framework=torch "
         "model=builtin://scaler?factor=2 ! tensor_sink name=out "
         "max-stored=64")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _stored(pipe):
    out, bufs = pipe.get("out"), []
    while True:
        b = out.pull(timeout=0.2)
        if b is None:
            return bufs
        bufs.append(b)


def _run(line, fuse):
    pipe = parse_launch(line, fuse=fuse)
    pipe.run(timeout=120)
    return pipe, _stored(pipe)


def _host(bufs):
    return [tuple(t.cpu().numpy().tobytes() for t in b.tensors)
            for b in bufs]


@pytest.mark.cuda
def test_outputs_are_cloned_out_of_the_pool(cuda_card):
    line = CHAIN.format(n=12, pattern="counter")
    fused_pipe, fused = _run(line, True)
    _, plain = _run(line, False)
    (seg,) = fused_pipe.fused_segments
    assert seg.stats["dispatches"] == 12 and seg.stats["retraces"] == 1
    assert all(t.is_cuda for b in fused for t in b.tensors)
    # twelve distinct frames, each in its own storage
    assert len({b.tensors[0].data_ptr() for b in fused}) == 12
    assert _host(fused) == _host(plain)
    assert len(set(_host(fused))) == 12


@pytest.mark.cuda
def test_one_capture_per_signature(cuda_card):
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=8:2,"
        "types=float32 ! tensor_transform mode=arithmetic option=add:1 "
        "! tensor_filter framework=torch model=builtin://scaler?factor=2 "
        "! tensor_sink name=out max-stored=64")
    pipe.play()
    try:
        src = pipe.get("in")
        src.push_buffer(np.ones((2, 8), np.float32))
        deadline = time.monotonic() + 30
        while (pipe.get("out").buffer_count < 1
               and time.monotonic() < deadline):
            time.sleep(0.05)
        (seg,) = pipe.fused_segments
        head = seg.head
        for shape in ((4, 8), (2, 8), (4, 8), (3, 5)):
            x = torch.arange(np.prod(shape), dtype=torch.float32,
                             device=cuda_card).reshape(shape)
            seg.dispatch(head.sinkpad, Buffer([x]))
        src.end_of_stream()
        pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert seg.stats["retraces"] == 3      # (2,8), (4,8), (3,5)
    assert seg.stats["dispatches"] == 5
    bufs = _stored(pipe)
    assert len(bufs) == 5
    x = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    assert torch.equal(bufs[4].tensors[0].cpu(), (x + 1) * 2)


@pytest.mark.cuda
def test_thread_local_capture_beside_another_pipeline(cuda_card):
    busy = parse_launch(
        "tensor_src device=true num-buffers=-1 dimensions=64:64 "
        "types=float32 pattern=random ! tensor_filter framework=torch "
        "model=builtin://matmul?n=64 ! queue ! tensor_sink name=out "
        "max-stored=1")
    busy.play()
    try:
        line = CHAIN.format(n=16, pattern="counter")
        fused_pipe, fused = _run(line, True)
        assert busy.playing
    finally:
        busy.stop()
    _, plain = _run(line, False)
    assert fused_pipe.fused_segments[0].stats["retraces"] == 1
    assert _host(fused) == _host(plain)
    msg = busy.bus.pop(timeout=0.1)
    while msg is not None:
        assert msg.type is not MessageType.ERROR, msg
        msg = busy.bus.pop(timeout=0.1)


@pytest.mark.cuda
def test_stager_overlaps_and_retargets(cuda_card):
    s = DoubleBufferedStager(cuda_card)
    frames = [np.random.default_rng(i).integers(0, 255, (64, 224, 224, 3),
                                                dtype=np.uint8)
              for i in range(3)]
    got = []
    for f in frames:
        (d,) = s.stage([f])
        got.append(d)
    torch.cuda.synchronize()
    for f, d in zip(frames, got):
        assert d.is_cuda and np.array_equal(d.cpu().numpy(), f)
    assert s.snapshot()["puts"] == 3
    # overlap: the caller's stream is busy for ~50 ms; the copy on the
    # side stream finishes inside that window
    busy_done = torch.cuda.Event()
    torch.cuda._sleep(100_000_000)
    busy_done.record()
    s.stage([frames[0]])
    slot = s._slots[(s._turn - 1) % 2]
    slot.done.synchronize()
    assert not busy_done.query()
    torch.cuda.synchronize()
    s.retarget(cuda_card)
    assert all(sl.done is None for sl in s._slots)


def _syncing_model(declared: bool):
    mod = types.ModuleType(f"_nns_fusion_sync_model_{int(declared)}")

    def model(x):
        if float(x.sum().item()) < 0:   # a host sync: illegal in a capture
            return (x,)
        return (x * 2,)

    if declared:
        model.capture_safe = True   # wrongly: the capture must fail
    mod.model = model
    sys.modules[mod.__name__] = mod
    return f"{mod.__name__}:model"


@pytest.mark.cuda
def test_undeclared_syncing_model_runs_with_the_default_fuse(cuda_card):
    model = _syncing_model(declared=False)
    line = ("tensor_src device=true num-buffers=4 dimensions=8 "
            "types=float32 pattern=counter ! tensor_transform "
            "mode=arithmetic option=add:1 ! tensor_filter framework=torch "
            f"model={model} ! tensor_sink name=out max-stored=4")
    pipe, fused = _run(line, None)
    (seg,) = pipe.fused_segments
    assert seg.stats["defused"] == 1 and seg.stats["dispatches"] == 0
    _, plain = _run(line, False)
    assert len(fused) == 4 and _host(fused) == _host(plain)


@pytest.mark.cuda
def test_capture_failure_is_a_bus_error(cuda_card):
    model = _syncing_model(declared=True)
    pipe = parse_launch(
        "tensor_src device=true num-buffers=4 dimensions=8 types=float32 "
        "pattern=counter ! tensor_transform mode=arithmetic option=add:1 "
        f"! tensor_filter framework=torch model={model} ! tensor_sink "
        "name=out")
    pipe.play()
    try:
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg.type is MessageType.ERROR
    (seg,) = pipe.fused_segments
    assert seg.stats["dispatches"] == 0 and seg.stats["defused"] == 0
    assert pipe.get("out").buffer_count == 0
    # unfused, the same line runs
    plain = parse_launch(
        "tensor_src device=true num-buffers=4 dimensions=8 types=float32 "
        "pattern=counter ! tensor_transform mode=arithmetic option=add:1 "
        f"! tensor_filter framework=torch model={model} ! tensor_sink "
        "name=out", fuse=False)
    assert plain.run(timeout=60).type is MessageType.EOS


@pytest.mark.cuda
def test_failed_capture_leaves_the_rng_usable(cuda_card):
    """A capture whose end fails never ran the generator's capture
    epilogue; the segment resets the generator, so a random op on the
    card afterwards runs (it used to raise "Offset increment outside
    graph capture encountered unexpectedly") and continues the stream."""
    torch.cuda.manual_seed(7)
    want = torch.rand(4, device=cuda_card)
    torch.cuda.manual_seed(7)
    model = _syncing_model(declared=True)
    pipe = parse_launch(
        "tensor_src device=true num-buffers=2 dimensions=8 types=float32 "
        "pattern=counter ! tensor_transform mode=arithmetic option=add:1 "
        f"! tensor_filter framework=torch model={model} ! tensor_sink "
        "name=out")
    pipe.play()
    try:
        assert pipe.wait(timeout=60).type is MessageType.ERROR
    finally:
        pipe.stop()
    torch.testing.assert_close(torch.rand(4, device=cuda_card), want)
