"""The stream-structure elements, the filter's hot swap and suspend, and
SingleShot on the card (marker ``cuda``; skips without a card). This file
needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_streams_cuda.py

* device residency: every tensor between a ``tensor_src device=true`` and
  the sinks of a tensor_if → tee → two filters → tensor_mux →
  tensor_demux line stays on cuda:0, and a tensor_merge of card parts
  (and of a card part with a stray host part) is one ``torch.cat`` there;
* tensor_if on the card: the a-value routing equals the host decision,
  and the float32 reduce agrees with the host's float64 within 1e-6;
* a hot swap on a captured segment: the outputs flip once, the segment
  re-captures, the first new-model output is bit-equal to a fresh
  capture of the new model, and the old weights go only after the fence
  behind the last old replay has completed (the filter's ``swap_log``);
* suspend: the weights' bytes leave ``torch.cuda.memory_allocated`` and
  the next buffer reopens the model with bit-equal outputs;
* SingleShot on cuda:0, from the calling thread and from another one,
  with a timed-out invoke's late result never returned."""
import gc
import threading
import time

import pytest
import torch

from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.single import SingleShot


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _settle(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.01)
    return predicate()


def _tap_devices(pipe):
    """Every buffer crossing every linked pad: the devices of its tensors."""
    seen = []
    for el in pipe.elements.values():
        for pad in el.src_pads:
            if not pad.is_linked:
                continue
            orig = pad.push

            def push(buf, _orig=orig, _pad=pad):
                seen.append((_pad.full_name, tuple(
                    str(t.device) if isinstance(t, torch.Tensor) else "host"
                    for t in buf.tensors)))
                return _orig(buf)
            pad.push = push
    return seen


@pytest.mark.cuda
def test_branch_and_join_stay_on_the_card(cuda_card):
    line = ("tensor_src device=true dimensions=3:8:8:4 types=uint8 "
            "pattern=random num-buffers=12 name=src ! tensor_if "
            "compared-value=a-value compared-value-option=0:0 operator=lt "
            "supplied-value=64 then=passthrough else=skip ! tee name=t "
            "t. ! queue ! tensor_filter framework=torch "
            "model=builtin://scaler?factor=2 ! mux.sink_0 "
            "t. ! queue ! tensor_filter framework=torch "
            "model=builtin://add?value=3 ! mux.sink_1 "
            "tensor_mux name=mux ! tensor_demux name=d tensorpick=0,1 "
            "d.src_0 ! tensor_sink name=a max-stored=0 "
            "d.src_1 ! tensor_sink name=b max-stored=0")
    pipe = parse_launch(line)
    seen = _tap_devices(pipe)
    frames = []
    src = pipe.get("src")
    orig_create = src.create

    def create():
        b = orig_create()
        if b is not None:
            frames.append(b.tensors[0].clone())
        return b
    src.create = create
    pipe.run(timeout=120)
    assert seen and all(d == "cuda:0" for _, devs in seen for d in devs)
    passed = [f for f in frames if int(f.reshape(-1)[0].cpu()) < 64]
    a, b = pipe.get("a"), pipe.get("b")
    outs_a = [a.pull(timeout=1) for _ in range(a.buffer_count)]
    outs_b = [b.pull(timeout=1) for _ in range(b.buffer_count)]
    assert len(outs_a) == len(outs_b) == len(passed)
    for f, oa, ob in zip(passed, outs_a, outs_b):
        assert torch.equal(oa.tensors[0], f.float() * 2)
        assert torch.equal(ob.tensors[0], f.float() + 3)


@pytest.mark.cuda
def test_merge_and_split_on_the_card(cuda_card):
    line = ("tensor_src device=true dimensions=3:8:8:4 types=uint8 "
            "pattern=random num-buffers=3 ! tee name=t "
            "t. ! queue ! m.sink_0 t. ! queue ! m.sink_1 "
            "tensor_merge name=m mode=linear option=0 ! tee name=mt "
            "mt. ! queue ! tensor_sink name=merged max-stored=0 "
            "mt. ! queue ! tensor_split name=s axis=0 tensorseg=4,4 "
            "s.src_0 ! tensor_sink name=a max-stored=0 "
            "s.src_1 ! tensor_sink name=b max-stored=0")
    pipe = parse_launch(line)
    pipe.run(timeout=60)
    for _ in range(3):
        m = pipe.get("merged").pull(timeout=1).tensors[0]
        x = pipe.get("a").pull(timeout=1).tensors[0]
        y = pipe.get("b").pull(timeout=1).tensors[0]
        assert m.device == cuda_card and x.device == y.device == cuda_card
        assert tuple(m.shape) == (8, 8, 8, 3)
        assert torch.equal(m, torch.cat([x, x])) and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tensor", "pinned", "numpy"])
def test_merge_uploads_a_stray_host_part(cuda_card, kind):
    host = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    h = {"tensor": host, "pinned": host.pin_memory(),
         "numpy": host.numpy()}[kind]
    dev = torch.ones(2, 4, device=cuda_card)
    pipe = parse_launch(
        "tensor_merge name=m option=0 ! tensor_sink name=out max-stored=0 "
        "appsrc name=d caps=other/tensors,format=static,dimensions=4:2,"
        "types=float32 ! m.sink_0 "
        "appsrc name=h caps=other/tensors,format=static,dimensions=4:3,"
        "types=float32 ! m.sink_1")
    pipe.play()
    try:
        pipe.get("d").push_buffer(Buffer([dev]))
        pipe.get("h").push_buffer(Buffer([h]))
        merged = pipe.get("out").pull(timeout=10).tensors[0]
    finally:
        pipe.get("d").end_of_stream()
        pipe.get("h").end_of_stream()
        pipe.wait(timeout=10)
        pipe.stop()
    assert merged.device == cuda_card
    assert torch.equal(merged, torch.cat([dev, host.to(cuda_card)]))


@pytest.mark.cuda
def test_tensor_if_reduce_on_the_card(cuda_card):
    from nnstreamer_tpu_torch.elements.cond import TensorIf

    g = torch.Generator().manual_seed(0)
    x = torch.rand(64, 224, 224, 3, generator=g)  # no cancellation
    for kind in ("tensor-total-value", "tensor-average-value"):
        el = TensorIf(compared_value=kind, compared_value_option="0",
                      operator="eq", supplied_value="0")
        dv, approx = el._compared_value(Buffer([x.to(cuda_card)]))
        hv, happrox = el._compared_value(Buffer([x]))
        assert approx and not happrox
        assert dv == pytest.approx(hv, rel=1e-6)
    a = TensorIf(compared_value="a-value", compared_value_option="0:77")
    assert a._compared_value(Buffer([x.to(cuda_card)]))[0] == \
        float(x.reshape(-1)[77])


@pytest.mark.cuda
def test_hot_swap_on_a_captured_segment(cuda_card):
    """reload_model mid-stream on the card: one boundary, a re-capture,
    the new model bit-equal to a fresh capture of it, and the old
    weights released after the fence of the last old replay."""
    pipe = parse_launch(
        "tensor_src device=true num-buffers=-1 framerate=200 "
        "dimensions=8:4 types=float32 pattern=counter ! tensor_transform "
        "mode=arithmetic option=add:1 ! tensor_filter framework=torch "
        "model=builtin://scaler?factor=2 name=f ! tensor_sink name=out "
        "max-stored=0")
    f, out = pipe.get("f"), pipe.get("out")
    pipe.play()
    try:
        assert _settle(lambda: out.buffer_count >= 5)
        (seg,) = pipe.fused_segments
        assert seg.stats["retraces"] == 1
        f.reload_model("builtin://scaler?factor=3")
        retired = f.backend._retired
        n = out.buffer_count
        assert _settle(lambda: out.buffer_count >= n + 5)
    finally:
        pipe.stop()
    vals = []
    while True:
        b = out.pull(timeout=0.2)
        if b is None:
            break
        assert b.tensors[0].is_cuda
        vals.append(float(b.tensors[0][0, 0]))
    factors = []
    for k, v in enumerate(vals):
        assert v in ((k + 1) * 2.0, (k + 1) * 3.0), (k, v)
        factors.append(2 if v == (k + 1) * 2.0 else 3)
    first3 = factors.index(3)
    assert all(x == 2 for x in factors[:first3])
    assert all(x == 3 for x in factors[first3:])
    assert seg.stats["retraces"] == 2
    assert [s for s, _ in f.swap_log] == ["segment fence", "released"]
    assert retired == []


@pytest.mark.cuda
def test_commit_waits_on_the_fence_of_the_last_replay(cuda_card):
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=8:4,"
        "types=float32 ! tensor_transform mode=arithmetic option=add:1 ! "
        "tensor_filter framework=torch model=builtin://scaler?factor=2 "
        "name=f ! tensor_sink name=out max-stored=0")
    f, out, src = pipe.get("f"), pipe.get("out"), pipe.get("in")
    pipe.play()
    try:
        for _ in range(3):
            src.push_buffer(torch.ones(4, 8, device=cuda_card))
        assert _settle(lambda: out.buffer_count == 3)
        (seg,) = pipe.fused_segments
        fence = seg._fence
        assert isinstance(fence, torch.cuda.Event)
        waited = []
        real = torch.cuda.Event.synchronize

        def spy(ev):
            waited.append(ev)
            return real(ev)
        torch.cuda.Event.synchronize = spy
        try:
            old = f.commit_model(f.prepare_model("builtin://scaler?factor=5"),
                                 "builtin://scaler?factor=5")
            f.release_prepared(old)
        finally:
            torch.cuda.Event.synchronize = real
        assert waited == [fence] and fence.query()
        assert old.props is None
        src.push_buffer(torch.ones(4, 8, device=cuda_card))
        assert _settle(lambda: out.buffer_count == 4)
        vals = [float(out.pull(timeout=1).tensors[0][0, 0]) for _ in range(4)]
        assert vals == [4.0, 4.0, 4.0, 10.0]
        assert seg.stats["retraces"] == 2
    finally:
        src.end_of_stream()
        pipe.wait(timeout=10)
        pipe.stop()


@pytest.mark.cuda
def test_suspend_frees_the_weights_and_reopens(cuda_card):
    n = 2048  # 16 MiB of float32 weights
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={n}:4,types=float32 ! tensor_filter framework=torch "
        f"model=builtin://matmul?n={n} suspend=200 name=f ! tensor_sink "
        "name=out max-stored=0")
    f, out, src = pipe.get("f"), pipe.get("out"), pipe.get("in")
    x = torch.randn(4, n, device=cuda_card)
    pipe.play()
    try:
        src.push_buffer(x)
        first = out.pull(timeout=30).tensors[0].clone()
        torch.cuda.synchronize(cuda_card)
        held = torch.cuda.memory_allocated(cuda_card)
        assert _settle(lambda: f.backend is None, 5)
        freed = held - torch.cuda.memory_allocated(cuda_card)
        assert freed >= n * n * 4, freed
        src.push_buffer(x)
        again = out.pull(timeout=30).tensors[0]
        assert torch.equal(first, again)
    finally:
        src.end_of_stream()
        pipe.wait(timeout=10)
        pipe.stop()


@pytest.mark.cuda
def test_singleshot_on_the_card_and_from_another_thread(cuda_card):
    x = torch.randn(4, 8, device=cuda_card)
    with SingleShot("torch", "builtin://scaler?factor=2",
                    timeout_ms=5000) as s:
        assert s.device == cuda_card
        out = s.invoke(x)
        assert out[0].device == cuda_card and torch.equal(out[0], x * 2)
        results = []

        def call():
            results.append((torch.cuda.current_device(),
                            s.invoke(x.cpu().numpy())))
        th = threading.Thread(target=call)
        th.start()
        th.join(30)
        (dev, got), = results
        assert got[0].device == cuda_card and torch.equal(got[0], x * 2)
    with SingleShot("torch", "builtin://sleeper?ms=300&factor=2",
                    timeout_ms=50) as s:
        s.invoke(x, timeout_ms=0)
        with pytest.raises(TimeoutError):
            s.invoke(x)
        time.sleep(0.4)
        fresh = s.invoke(x * 0 + 5, timeout_ms=5000)
        assert torch.equal(fresh[0], torch.full_like(x, 10.0))


@pytest.mark.cuda
def test_no_collection_runs_during_a_capture(cuda_card):
    """Segments form reference cycles with their elements, so a dropped
    pipeline's graphs go at a garbage collection; one that ran on the
    capturing thread mid-capture would destroy a graph there, which a
    capture forbids. With collections forced at every allocation, none
    may start while this thread's stream is capturing."""
    line = ("tensor_src device=true num-buffers=3 dimensions=8:4 "
            "types=float32 pattern=counter ! tensor_transform "
            "mode=arithmetic option=add:1 ! tensor_transform "
            "mode=arithmetic option=mul:2 ! tensor_sink name=out "
            "max-stored=0")
    during = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    thresholds = gc.get_threshold()
    gc.callbacks.append(watch)
    try:
        for _ in range(2):
            gc.set_threshold(1, 1, 1)
            pipe = parse_launch(line)
            pipe.run(timeout=60)
            (seg,) = pipe.fused_segments
            assert seg.stats["retraces"] == 1
            del pipe, seg          # the cycle holds the graph until a GC
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
        gc.collect()
    assert during == []
