"""The slice end to end on the CPU: the launch line

    appsrc ! tensor_filter framework=torch model=...lm_serving:<entry>
        accelerator=cpu ! tensor_sink

returns exactly the tokens of nnstreamer_tpu's ``framework=jax`` pipeline
on the same prompts and the same weights (the JAX ``tiny`` entry's seed-0
parameters, carried into the port's entry by models/convert.py)."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.models import lm_serving
from nnstreamer_tpu_torch.runtime.parse import parse_launch

MODULE = __name__
# the port's tiny entry carrying nnstreamer_tpu's tiny weights; set by the
# ``carried`` fixture, named by the launch lines below as MODULE:CARRIED
CARRIED = None


@pytest.fixture(scope="module")
def carried():
    cfg = jtr.TransformerConfig(vocab=64, dim=32, heads=4, layers=2,
                                max_seq=64)
    tree = jax.tree_util.tree_map(np.asarray, jtr.init_params(cfg, seed=0))
    entry = dataclasses.replace(lm_serving.tiny, params=tree)
    setattr(sys.modules[MODULE], "CARRIED", entry)
    return entry


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 64, (4, 6)).astype(np.int32) for _ in range(2)]


def _run(parse, framework_model: str, prompts, extra: str = ""):
    B, P = prompts[0].shape
    pipe = parse(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={P}:{B},types=int32 "
        f"! tensor_filter {framework_model} {extra} name=f "
        f"! tensor_sink name=out max-stored={len(prompts)}")
    outs = []
    pipe.get("out").connect(lambda b: outs.append(b))
    pipe.play()
    try:
        src = pipe.get("in")
        for p in prompts:
            src.push_buffer(p)
        src.end_of_stream()
        msg = pipe.wait(timeout=120)
        filt = pipe.get("f")
        entry = getattr(filt.backend, "model_entry", None)
        caps = pipe.get("out").sinkpad.caps
    finally:
        pipe.stop()
    assert msg.type.value == "eos", msg
    return outs, entry, caps


def test_port_pipeline_equals_jax_pipeline(carried, prompts):
    want, _, _ = _run(jax_parse_launch,
                      "framework=jax model=nnstreamer_tpu.models.lm_serving:tiny",
                      prompts)
    got, entry, caps = _run(parse_launch,
                            f"framework=torch model={MODULE}:CARRIED "
                            "accelerator=cpu", prompts)
    assert entry is carried
    assert str(caps) == ("other/tensors,format=static,num_tensors=1,"
                         "dimensions=14:4,types=int32")
    assert len(got) == len(want) == len(prompts)
    for g, w, p in zip(got, want, prompts):
        t = g.tensors[0]
        assert isinstance(t, torch.Tensor) and t.dtype is torch.int32
        host = g.as_numpy().tensors[0]
        np.testing.assert_array_equal(host[:, :6], p)
        np.testing.assert_array_equal(host, np.asarray(w.tensors[0]))


def test_serve_knobs_reach_the_entry(carried, prompts):
    """custom=serve_dtype/cache_len rebuild the entry; framework alias
    ``pytorch`` names the same backend."""
    got, entry, _ = _run(
        parse_launch, f"framework=pytorch model={MODULE}:CARRIED "
        "accelerator=cpu custom=serve_dtype:bfloat16,cache_len:32", prompts)
    assert entry.serve_dtype == "bfloat16" and entry.cache_len == 32
    assert entry.params is carried.params
    assert got[0].tensors[0].shape == (4, 14)


def test_no_card_posts_error_naming_the_device(prompts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the filter opens on it")
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=6:4,"
        "types=int32 ! tensor_filter framework=torch "
        "model=nnstreamer_tpu_torch.models.lm_serving:tiny name=f "
        "! tensor_sink name=out")
    pipe.play()
    try:
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=30)
    finally:
        pipe.stop()
    assert msg is not None and msg.source == "f"
    assert "no CUDA device" in msg.data["error"]
    assert "accelerator=cpu" in msg.data["error"]


@pytest.mark.parametrize("launch,needle", [
    ("accelerator=tpu", "not a valid Accelerator"),
    ("accelerator=cpu custom=device:0", "conflicts with accelerator=cpu"),
    ("accelerator=cpu custom=cache_len:x", "not an integer"),
])
def test_bad_filter_options_post_errors(launch, needle):
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=6:4,"
        "types=int32 ! tensor_filter framework=torch "
        f"model=nnstreamer_tpu_torch.models.lm_serving:tiny {launch} "
        "! tensor_sink")
    pipe.play()
    try:
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=30)
    finally:
        pipe.stop()
    assert msg is not None and needle in msg.data["error"]


def scale2(x):
    """A plain callable model: no shape rule, so output caps are flexible."""
    return x * 2


def test_tensor_src_through_a_plain_callable():
    pipe = parse_launch(
        "tensor_src num-buffers=3 dimensions=3:2 types=float32 pattern=counter "
        f"! tensor_filter framework=torch model={MODULE}:scale2 "
        "accelerator=cpu ! tensor_sink name=out")
    pipe.play()
    try:
        msg = pipe.wait(timeout=30)
        sink = pipe.get("out")
        bufs = [sink.pull(timeout=1) for _ in range(3)]
        caps = sink.sinkpad.caps
    finally:
        pipe.stop()
    assert msg.type is MessageType.EOS
    assert caps.first.get("format") == "flexible"
    for i, b in enumerate(bufs):
        np.testing.assert_array_equal(b.as_numpy().tensors[0],
                                      np.full((2, 3), 2.0 * i, np.float32))
