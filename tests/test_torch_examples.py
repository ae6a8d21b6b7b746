"""The port's example twins (``examples/*_torch.py``) against the
reference's scripts (``examples/*.py``) on the CPU, on the same inputs and
the same weights.

Each twin runs as a subprocess with ``--device cpu`` (the multi-rank ones
on the gloo worlds of ``tests/test_torch_mesh_serving.py::spawn_world``,
each rank running the script itself); nnstreamer_tpu's weights reach it
through ``--params`` (a ``.npz`` of the reference's pytree, converted by
``models/convert.py``). The reference side is its script where the
script's output carries what is compared (the three query scripts run as
they are), else the script's own lines and calls in this process with the
same inputs (the LM scripts, where the reference samples from
``jax.random`` or prints one row, and the MobileNet-v2 scripts, where the
reference draws its frames from ``jax.random`` or names a file the repo
does not carry).

Exact: greedy tokens, labels, scaler values and shard order. Train losses
within 5e-5 (the bound of ``tests/test_torch_parallel.py``)."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_mesh_serving import pytree, spawn_world

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(ROOT, "examples")
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "mobilenet_v2_1.0_224_int8.tflite")

# a spawned rank runs the twin itself, jax and nnstreamer_tpu blocked
SHIM = r'''
import os, runpy, sys
for name in ("jax", "jaxlib", "flax", "optax", "nnstreamer_tpu"):
    sys.modules[name] = None
script = os.path.join(os.environ["NNS_REPO"], "examples", {script!r})
job, data_path, out_dir = sys.argv[1:4]
sys.argv = [script, "--device", "cpu", "--params", data_path,
            "--out", out_dir] + {extra!r}
runpy.run_path(script, run_name="__main__")
'''


def shim(script, *extra):
    return SHIM.format(script=script, extra=list(extra))


def start(script, *args, env=None, cwd=None):
    """A script of ``examples/`` in a child process."""
    return subprocess.Popen(
        [sys.executable, os.path.join(EX, script), *args],
        cwd=cwd or ROOT, env=dict(os.environ, **(env or {})), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(proc, timeout=240):
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert proc.returncode == 0, out[-4000:]
    return out


def last_json(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def npz(path, **arrays):
    np.savez(path, **arrays)
    return str(path)


# ---------------------------------------------------------------------------
# LM generation and serving
# ---------------------------------------------------------------------------

def _reference_lm():
    from nnstreamer_tpu.models.transformer import TransformerConfig, init_params

    # examples/generate_lm.py's model
    cfg = TransformerConfig(vocab=64, dim=64, heads=4, layers=2, max_seq=48)
    return cfg, init_params(cfg, seed=0)


def _reference_greedy(cfg, params, prompt, steps):
    from nnstreamer_tpu.models.decoding import make_generate

    return np.asarray(make_generate(cfg, temperature=0.0)(
        params, jnp.asarray(prompt), steps))


def test_generate_lm_greedy_tokens_match_the_reference(tmp_path):
    """One process, meshless: the reference script's prompt (batch 2 on a
    world of one) and 16 greedy steps, token for token; the launches line
    precedes the tokens (0 on the CPU: the wrappers' plain versions)."""
    cfg, params = _reference_lm()
    data = npz(tmp_path / "p.npz", params=pytree(params))
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    out = finish(start("generate_lm_torch.py", "--device", "cpu", "--config",
                       "tiny", "--params", data, "--out", str(out_dir)))
    tokens = np.load(out_dir / "arrays.npz")["tokens"]
    prompt = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    np.testing.assert_array_equal(tokens[0],
                                  _reference_greedy(cfg, params, prompt, 16))
    lines = out.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.startswith("launches: ")]
    assert at and json.loads(lines[at[0]][len("launches: "):]) == {
        "decode_attention": 0, "flash_attention": 0}
    assert "greedy" in lines[0] and "meshless" in lines[0]


def test_generate_lm_samples_from_a_seeded_torch_generator(tmp_path):
    """--temperature draws from a torch.Generator seeded with --seed: the
    same seed gives the same tokens, the prompt is echoed, every token is
    in the vocabulary (not the reference's jax.random stream)."""
    runs = []
    for _ in range(2):
        d = tmp_path / f"o{len(runs)}"
        d.mkdir()
        finish(start("generate_lm_torch.py", "--device", "cpu", "--config",
                     "tiny", "--temperature", "0.8", "--seed", "42",
                     "--out", str(d)))
        runs.append(np.load(d / "arrays.npz")["tokens"][0])
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0][:, :6], np.tile(np.arange(6), (2, 1)))
    assert runs[0].min() >= 0 and runs[0].max() < 64


def test_generate_lm_on_a_dp2_tp2_world_matches_the_reference(tmp_path):
    """Four gloo ranks (the reference's mesh rule: dp = world // 2, tp =
    2): the batch of 4 over dp, the heads over tp, every rank holding the
    global batch's greedy tokens."""
    cfg, params = _reference_lm()
    outs, arrays = spawn_world(
        tmp_path, shim("generate_lm_torch.py", "--config", "tiny"), "gen4",
        4, dict(params=pytree(params)))
    assert all(o["mesh"] == {"dp": 2, "tp": 2} for o in outs)
    prompt = np.tile(np.arange(6, dtype=np.int32), (4, 1))
    np.testing.assert_array_equal(arrays["tokens"][0],
                                  _reference_greedy(cfg, params, prompt, 16))


def _ref_lines(prompts):
    """examples/serve_lm_pipeline.py's two lines on nnstreamer_tpu (the
    filter with custom=mesh:2x4, the streaming tensor_generate mesh=2x4)."""
    from nnstreamer_tpu.core import MessageType
    from nnstreamer_tpu.runtime.parse import parse_launch

    B, P = prompts[0].shape
    caps = ("appsrc name=in caps=other/tensors,format=static,"
            f"dimensions={P}:{B},types=int32 ")
    got = {}
    for key, line, pushes in (
            ("filter", caps + "! tensor_filter framework=jax "
             "model=nnstreamer_tpu.models.lm_serving:tiny custom=mesh:2x4 "
             "name=lm ! tensor_sink name=out max-stored=8", prompts),
            ("stream", caps + "! tensor_generate "
             "model=nnstreamer_tpu.models.lm_serving:tiny steps=8 mesh=2x4 "
             "! tensor_sink name=out max-stored=16", prompts[:1])):
        pipe = parse_launch(line)
        bufs = []
        pipe.get("out").connect(lambda b: bufs.append(np.asarray(b.tensors[0])))
        pipe.play()
        for p in pushes:
            pipe.get("in").push_buffer(p)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=120)
        pipe.stop()
        assert msg is not None and msg.type is MessageType.EOS, msg
        got[key] = bufs
    return np.stack(got["filter"]), np.stack([b[:, 0] for b in got["stream"]], 1)


def test_serve_lm_pipeline_mesh_2x4_matches_the_reference(tmp_path):
    """The filter line under ``custom=mesh:2x4`` and the streaming line
    under ``mesh=2x4`` on an 8-rank gloo world, the reference's script's
    prompts (``default_rng(0)``, two (4, 6) batches) and its ``tiny``
    weights: both lines' tokens equal the reference's lines', and the
    streamed tokens the filter's first 8."""
    from nnstreamer_tpu.models.lm_serving import tiny
    from nnstreamer_tpu.models.transformer import init_params

    outs, arrays = spawn_world(
        tmp_path, shim("serve_lm_pipeline_torch.py", "--config", "tiny"),
        "serve8", 8, dict(params=pytree(init_params(tiny.cfg, seed=0))))
    for o in outs:
        assert o["mesh"] == {"dp": 2, "tp": 4}
        assert o["stream_mesh"] == {"dp": 2, "tp": 4}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (4, 6)).astype(np.int32)
               for _ in range(2)]
    want_filter, want_stream = _ref_lines(prompts)
    np.testing.assert_array_equal(arrays["filter"], want_filter)
    np.testing.assert_array_equal(arrays["stream"], want_stream)
    np.testing.assert_array_equal(arrays["stream"], arrays["filter"][0][:, 6:])


def test_train_parallel_world_one_matches_the_reference(tmp_path):
    """The twin's world-1 form (what it runs on one card) says so, and its
    five ring + MoE steps and the four stages in sequence give the
    reference's dp2×tp2×sp2 and pp4×dp2 losses within 5e-5 (the 8-rank
    form runs in tests/test_torch_parallel.py)."""
    from test_torch_parallel import _reference_lm_steps

    from nnstreamer_tpu.models.transformer import TransformerConfig, init_params
    from nnstreamer_tpu.parallel import make_mesh
    from nnstreamer_tpu.parallel.pipeline import make_pipeline, stack_stage_params

    tree = jax.tree_util.tree_map(np.asarray, init_params(
        TransformerConfig(vocab=64, dim=32, heads=2, layers=2, max_seq=17,
                          moe_experts=4)))
    toks = np.random.default_rng(0).integers(0, 64, (4, 17)).astype(np.int32)
    pp_w = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(i),
                                                  (16, 16)) * 0.3)
                     for i in range(4)])
    pp_xs = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (4, 2, 16)))
    data = npz(tmp_path / "d.npz", params=pytree(tree), tokens=toks,
               pp_w=pp_w, pp_xs=pp_xs)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    out = finish(start("train_parallel_torch.py", "--device", "cpu",
                       "--params", data, "--out", str(out_dir)))
    assert "world 1 (one rank)" in out
    got = json.loads((out_dir / "out0.json").read_text())
    assert got["world"] == 1 and "in sequence" in got["pp"]
    want, _ = _reference_lm_steps("ring", 2, tree, toks)
    np.testing.assert_allclose(got["losses-ring"], want, atol=5e-5, rtol=0)

    mesh_pp = make_mesh(jax.devices(), {"pp": 4, "dp": 2})
    run = make_pipeline(lambda p, x: jnp.tanh(x @ p["w"]), 4, mesh_pp)
    stacked = stack_stage_params([{"w": jnp.asarray(w)} for w in pp_w])
    grad_step = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(run(p, jnp.asarray(pp_xs)) ** 2)))
    losses = []
    for _ in range(5):
        loss, grads = grad_step(stacked)
        stacked = jax.tree_util.tree_map(lambda p, g: p - 0.3 * g, stacked,
                                         grads)
        losses.append(float(loss))
    np.testing.assert_allclose(got["pp_losses"], losses, atol=5e-5, rtol=0)


# ---------------------------------------------------------------------------
# MobileNet-v2 lines
# ---------------------------------------------------------------------------

def _reference_labels(model: str, frames, caps_type: str, fi: int):
    """``appsrc ! tensor_filter framework=jax ! tensor_decoder
    mode=image_labeling frames-in=fi ! tensor_sink`` on nnstreamer_tpu."""
    from nnstreamer_tpu.runtime.parse import parse_launch

    b = frames[0].shape[0]
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions=3:224:224:{b},types={caps_type} "
        f"! tensor_filter framework=jax model={model} "
        f"! tensor_decoder mode=image_labeling frames-in={fi} "
        "! tensor_sink name=out")
    got = []
    pipe.get("out").connect(lambda buf: got.append(buf.meta["label_index"]))
    pipe.play()
    for f in frames:
        pipe.get("in").push_buffer(f)
    pipe.get("in").end_of_stream()
    pipe.wait(timeout=300)
    pipe.stop()
    return [int(x) for x in got]


def test_device_resident_classify_labels_match_the_reference(tmp_path):
    """BATCH=2, BUFFERS=2 on the CPU with the reference's seed-0 float32
    weights: the twin's labels equal the reference's filter_model_u8 and
    batched labeling decoder on the same frames (the port's device
    source's, which the reference draws from jax.random instead), and it
    pulls one int32 per frame, never the full logits."""
    import torch

    from nnstreamer_tpu.models.mobilenet_v2 import build_mobilenet_v2
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    proc = start("device_resident_classify_torch.py", "--device", "cpu",
                 "--params", npz(tmp_path / "w.npz", params=pytree(
                     build_mobilenet_v2(compute_dtype="float32")[1])),
                 env={"BATCH": "2", "BUFFERS": "2"})
    src = parse_launch("tensor_src device=true accelerator=cpu "
                       "pattern=random num-buffers=2 "
                       "dimensions=3:224:224:2 types=uint8 "
                       "! tensor_sink name=out max-stored=0")
    frames = []
    src.get("out").connect(lambda b: frames.append(
        b.tensors[0].to(torch.uint8).numpy().copy()))
    src.run(timeout=60)
    want = _reference_labels(
        "nnstreamer_tpu.models.mobilenet_v2:filter_model_u8", frames,
        "uint8", 2)
    got = last_json(finish(proc))
    assert len(want) == 4
    assert got["labels"] == want
    assert got["pulled_bytes_per_frame"] == 4 and got["host_decodes"] == 0


def test_classify_tflite_labels_match_the_reference(tmp_path):
    """The committed int8 fixture (the twin's default model) in the port's
    default mode, fake-quant: the reference script's line (with the
    fixture's int8 input type; the reference's default file is not in the
    repo) gives the same four labels on the same tensor_src frames."""
    from nnstreamer_tpu.runtime.parse import parse_launch

    proc = start("classify_tflite_on_xla_torch.py", "--device", "cpu")
    pipe = parse_launch(
        "tensor_src num-buffers=4 dimensions=3:224:224:1 types=int8 "
        f"pattern=random ! tensor_filter framework=jax model={FIXTURE} "
        "! tensor_decoder mode=image_labeling ! tensor_sink name=out")
    want = []
    pipe.get("out").connect(lambda b: want.append(b.meta.get("label")))
    pipe.run(timeout=300)
    got = last_json(finish(proc))
    assert got["mode"] == "fake-quant" and len(want) == 4
    assert got["labels"] == want


# ---------------------------------------------------------------------------
# query offload, hybrid discovery, sharding: both scripts as they are
# ---------------------------------------------------------------------------

def _floats(text: str, pattern: str) -> list:
    m = re.search(pattern, text)
    assert m, text[-3000:]
    return json.loads(m.group(1))


def test_offload_with_reconnect_matches_the_reference():
    """The worker killed and restarted mid-stream: both scripts' last
    three answers are x2 before and x5 after; the twin also counts the
    frames dropped during the outage."""
    ref = start(os.path.join(EX, "offload_with_reconnect.py"))
    twin = start("offload_with_reconnect_torch.py", "--device", "cpu")
    ref_out, got = finish(ref), last_json(finish(twin))
    assert got["before"] == _floats(ref_out, r"answered \d+ frames: (\[.*\])")
    assert got["after"] == _floats(ref_out, r"answers after restart: (\[.*?\])")
    assert got["before"] == [2.0] * 3 and got["after"] == [5.0] * 3
    assert got["dropped"] == got["pushed"] - got["answered"] >= 0
    assert got["resumed"] >= 5


def test_hybrid_discovery_matches_the_reference():
    """The worker moved to a new ephemeral port: both clients re-discover
    it through the broker and answer 10.0 before, 70.0 after."""
    ref = start(os.path.join(EX, "hybrid_discovery.py"))
    twin = start("hybrid_discovery_torch.py", "--device", "cpu")
    ref_out, got = finish(ref), last_json(finish(twin))
    assert "OK" in ref_out
    assert [got["before"], got["after"]] == [
        _floats(ref_out, r"answer via discovered worker: ([\d.]+)"),
        _floats(ref_out, r"answer after the move: ([\d.]+)")]
    assert got["ports"][0] != got["ports"][1] and got["resumed"] >= 1


def test_sharded_stream_order_matches_the_reference():
    """Twelve frames round-robin over two workers and re-joined: the same
    values in the same order, each worker answering half."""
    ref = start(os.path.join(EX, "sharded_stream.py"))
    twin = start("sharded_stream_torch.py", "--device", "cpu")
    ref_out, got = finish(ref), last_json(finish(twin))
    assert got["values"] == _floats(ref_out, r"workers: (\[.*\])")
    assert got["in_order"] and got["per_worker_invokes"] == [6, 6]


@pytest.mark.parametrize("script", sorted(
    f for f in os.listdir(EX) if f.endswith("_torch.py")))
def test_twin_without_a_card_fails_typed(script):
    """With no card and no --device, every twin stops with the port's
    typed error naming the missing device (no CPU carry-on)."""
    r = subprocess.run([sys.executable, os.path.join(EX, script)],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "RuntimeError: no CUDA device available" in r.stderr, \
        r.stderr[-2000:]
