"""The mesh surfaces of the port's LM serving against nnstreamer_tpu's.

The port runs SPMD, one process per rank: each test spawns a gloo world
(every rank runs the same lines on the same prompts, rank 0 reports) and
the JAX package runs the same serving on its 8 virtual CPU devices, with
the same weights (``models/convert.py``). Tokens are compared exactly.

* world 4: ``tensor_filter custom=mesh:2x2`` and ``mesh:dp=4`` (mirrors
  ``tests/test_lm_serving.py:42-92``, 2x2 in place of 2x4),
  ``make_sharded`` called directly, ``make_streaming(mesh=)`` and a
  two-turn ``make_session(mesh=)``, ``tensor_generate mesh=2x2`` (mirrors
  ``tests/test_generate.py:80``), ``make_generate`` on a dp2×tp2 mesh,
  context-parallel generation at sp=2 (dp2×sp2, tp2×sp2) and sp=4 and its
  errors (mirrors ``tests/test_decoding.py:100-180``), and the MoE model
  on a dp2×tp2 mesh;
* world 3: ``custom=mesh:1x3`` on the 4-head entry posts the reference's
  heads error.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(r'''
    import json, os, sys
    sys.path.insert(0, os.environ["NNS_REPO"])
    for name in ("jax", "jaxlib", "flax", "optax", "nnstreamer_tpu"):
        sys.modules[name] = None
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch
    from nnstreamer_tpu_torch.models import lm_serving
    from nnstreamer_tpu_torch.models.convert import params_from_jax
    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig, shard_params)
    from nnstreamer_tpu_torch.parallel import init_multihost, make_mesh
    from nnstreamer_tpu_torch.parallel import collectives as C
    from nnstreamer_tpu_torch.parallel.mesh import (
        axis_group, axis_index, axis_size)

    job, data_path, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    data = dict(np.load(data_path, allow_pickle=True))
    assert init_multihost()
    rank = dist.get_rank()
    out, arrays = {}, {}
    tiny_ref = replace(lm_serving.tiny, params=data["tiny"].item())
    if "tiny_moe" in data:
        moe_ref = replace(lm_serving.tiny, params=data["tiny_moe"].item(),
                          cfg=replace(lm_serving.tiny.cfg, moe_experts=4))

    def launch(line, pushes, timeout=120):
        pipe = parse_launch(line)
        got = []
        pipe.get("out").connect(
            lambda b: got.append(np.asarray(b.as_numpy().tensors[0])))
        pipe.play()
        src = pipe.get("in")
        for p in pushes:
            src.push_buffer(p)
        src.end_of_stream()
        msg = pipe.wait(timeout=timeout)
        holder = pipe.elements.get("f")
        mesh = getattr(holder, "backend_mesh", None) or \
            getattr(holder, "mesh", None)
        pipe.stop()
        assert msg is not None and msg.type is MessageType.EOS, msg
        return got, mesh

    def error_of(line, push):
        pipe = parse_launch(line)
        pipe.play()
        pipe.get("in").push_buffer(push)
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=60)
        pipe.stop()
        return None if msg is None else str(msg.data.get("error", ""))

    def caps(p):
        B, P = p.shape
        return (f"appsrc name=in caps=other/tensors,format=static,"
                f"dimensions={P}:{B},types=int32 ")

    def filter_line(custom, p, model="tiny_ref"):
        return (caps(p) + "! tensor_filter framework=torch accelerator=cpu "
                f"model=__main__:{model} custom={custom} name=f "
                "! tensor_sink name=out max-stored=8")

    def shape_of(mesh):
        return dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))

    def gathered(t, mesh):
        return C.all_gather_plain(t, axis_group(mesh, "dp"), 0)

    def rows(t, mesh):
        return t.chunk(axis_size(mesh, "dp"))[axis_index(mesh, "dp")]

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    prompts = [data["p0"], data["p1"]]
    if job == "serve4":
        for name, custom in (("2x2", "mesh:2x2"), ("dp4", "mesh:dp=4")):
            got, mesh = launch(filter_line(custom, prompts[0]), prompts)
            out[f"mesh-{name}"] = shape_of(mesh)
            for i, g in enumerate(got):
                arrays[f"filter-{name}-{i}"] = g
        # a batch of 6 that dp=4 does not divide: whole on every rank,
        # the MoE routing counting its 6 rows once
        got, _ = launch(filter_line("mesh:dp=4", data["p6"], "moe_ref"),
                        [data["p6"]])
        arrays["moe-indivisible"] = got[0]
        mesh = make_mesh(None, {"dp": 2, "tp": 2})
        serve = tiny_ref.make_sharded(mesh, device="cpu")
        with torch.inference_mode():
            local = serve(rows(torch.from_numpy(prompts[0]), mesh))[0]
        arrays["sharded"] = gathered(local, mesh).numpy()
        out["sharded-local-rows"] = int(local.shape[0])
        stream = tiny_ref.make_streaming("cpu", mesh=mesh)
        arrays["stream"] = torch.stack(
            list(stream(prompts[0], 5)), 1).numpy()
        session = tiny_ref.make_session("cpu", mesh=mesh)
        for turn, (p, steps) in enumerate(((prompts[0], 4),
                                           (data["turn2"], 3))):
            arrays[f"session-{turn}"] = torch.stack(
                list(session.generate(p, steps)), 1).numpy()
        out["session-position"] = session.position
        got, gmesh = launch(
            caps(prompts[0]) + "! tensor_generate name=f accelerator=cpu "
            "model=__main__:tiny_ref steps=5 mesh=2x2 "
            "! tensor_sink name=out max-stored=16", prompts[:1])
        out["generate-mesh"] = shape_of(gmesh)
        arrays["generate-elem"] = np.concatenate(got, axis=1)

        cfg = TransformerConfig(vocab=31, dim=32, heads=4, layers=2,
                                max_seq=24)
        full = params_from_jax(data["dec"].item(), device="cpu")
        for name, sizes, cp, p, steps in (
                ("dp2tp2", {"dp": 2, "tp": 2}, False, data["p_mesh"], 5),
                ("cp-dp2sp2", {"dp": 2, "tp": 1, "sp": 2}, True,
                 data["p_cp"], 6),
                ("cp-tp2sp2", {"dp": 1, "tp": 2, "sp": 2}, True,
                 data["p_cp"], 6),
                ("cp-sp4", {"dp": 1, "tp": 1, "sp": 4}, True,
                 data["p_cp"], 6)):
            m = make_mesh(None, sizes)
            gen = make_generate(cfg, mesh=m, context_parallel=cp)
            got = gen(shard_params(cfg, m, full),
                      rows(torch.from_numpy(p), m), steps)
            arrays[name] = gathered(got, m).numpy()
        moe_cfg = TransformerConfig(vocab=17, dim=16, heads=2, layers=1,
                                    max_seq=12, moe_experts=4)
        m = make_mesh(None, {"dp": 2, "tp": 2})
        got = make_generate(moe_cfg, mesh=m)(
            shard_params(moe_cfg, m, params_from_jax(data["moe"].item(),
                                                     device="cpu")),
            rows(torch.from_numpy(data["p_moe"]), m), 4)
        arrays["moe"] = gathered(got, m).numpy()
        out["err-no-mesh"] = message(
            lambda: make_generate(cfg, context_parallel=True))
        bad = TransformerConfig(vocab=8, dim=8, heads=2, layers=1, max_seq=7)
        m = make_mesh(None, {"dp": 1, "tp": 2, "sp": 2})
        out["err-divide"] = message(
            lambda: make_generate(bad, mesh=m, context_parallel=True))
        m = make_mesh(None, {"dp": 2, "tp": 2})
        out["err-no-sp"] = message(
            lambda: make_generate(cfg, mesh=m, context_parallel=True))
    elif job == "heads3":
        out["error"] = error_of(filter_line("mesh:1x3", prompts[0]),
                                prompts[0])
    dist.barrier()
    with open(os.path.join(out_dir, f"out{rank}.json"), "w") as fh:
        json.dump(out, fh)
    if arrays and rank == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    dist.destroy_process_group()
''')


def spawn_world(tmp_path, worker, job, n, data, timeout_s=150):
    """Run ``worker``'s ``job`` in an ``n``-process gloo world (each rank
    blocks JAX and nnstreamer_tpu); return each rank's JSON and rank 0's
    arrays. Every process is killed on the way out."""
    prog = tmp_path / "worker.py"
    prog.write_text(worker)
    data_path = tmp_path / "data.npz"
    np.savez(data_path, **data)
    env = dict(os.environ, NNS_REPO=ROOT,
               NNS_COORD=f"file://{tmp_path / 'store'}",
               NNS_NUM_PROCS=str(n), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(prog), job, str(data_path),
                 str(tmp_path)],
                env=dict(env, NNS_PROC_ID=str(rank)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=timeout_s)[0].decode() for p in procs]
    finally:
        for p in procs:   # a rank stuck in a collective must not outlive us
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    outs = [json.loads((tmp_path / f"out{r}.json").read_text())
            for r in range(n)]
    arrays = (dict(np.load(tmp_path / "arrays.npz"))
              if (tmp_path / "arrays.npz").exists() else {})
    return outs, arrays


def pytree(tree):
    """A JAX parameter pytree as an object array for the .npz."""
    obj = np.empty((), dtype=object)
    obj[()] = jax.tree_util.tree_map(np.asarray, tree)
    return obj


def _ref_launch(line, pushes, sink="out"):
    from nnstreamer_tpu.core import MessageType
    from nnstreamer_tpu.runtime.parse import parse_launch

    pipe = parse_launch(line)
    got = []
    pipe.get(sink).connect(lambda b: got.append(np.asarray(b.tensors[0])))
    pipe.play()
    for p in pushes:
        pipe.get("in").push_buffer(p)
    pipe.get("in").end_of_stream()
    msg = pipe.wait(timeout=120)
    pipe.stop()
    assert msg is not None and msg.type is MessageType.EOS, msg
    return got


def _caps(p):
    B, P = p.shape
    return ("appsrc name=in caps=other/tensors,format=static,"
            f"dimensions={P}:{B},types=int32 ")


def _ref_filter(custom, prompts):
    return _ref_launch(
        _caps(prompts[0]) + "! tensor_filter framework=jax "
        f"model=nnstreamer_tpu.models.lm_serving:tiny custom={custom} "
        "! tensor_sink name=out max-stored=8", prompts)


def _ref_mesh(sizes):
    from nnstreamer_tpu.parallel.mesh import make_mesh

    n = int(np.prod(list(sizes.values())))
    return make_mesh(jax.devices()[:n], sizes)


def _ref_sharded(cfg, params, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from nnstreamer_tpu.models.transformer import param_pspecs

    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), param_pspecs(cfg),
        is_leaf=lambda x: isinstance(x, P))
    return jax.device_put(params, shardings)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from nnstreamer_tpu.models.lm_serving import tiny
    from nnstreamer_tpu.models.transformer import (
        TransformerConfig,
        init_params,
    )

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, (4, 6)).astype(np.int32)
               for _ in range(2)]
    dec_cfg = TransformerConfig(vocab=31, dim=32, heads=4, layers=2,
                                max_seq=24)
    moe_cfg = TransformerConfig(vocab=17, dim=16, heads=2, layers=1,
                                max_seq=12, moe_experts=4)
    data = dict(
        tiny=pytree(init_params(tiny.cfg, seed=0)),
        tiny_moe=pytree(init_params(replace(tiny.cfg, moe_experts=4),
                                    seed=0)),
        p6=rng.integers(0, 64, (6, 5)).astype(np.int32),
        dec=pytree(init_params(dec_cfg, seed=3)),
        moe=pytree(init_params(moe_cfg, seed=1)),
        p0=prompts[0], p1=prompts[1],
        turn2=rng.integers(0, 64, (4, 3)).astype(np.int32),
        p_mesh=np.array([[1, 2], [3, 4]], np.int32),
        p_cp=np.array([[1, 2, 3], [7, 6, 5]], np.int32),
        p_moe=np.array([[1, 2, 3], [4, 5, 6]], np.int32))
    outs, arrays = spawn_world(tmp_path_factory.mktemp("serve4"), WORKER,
                               "serve4", 4, data)
    return dict(outs=outs, arrays=arrays, data=data, dec_cfg=dec_cfg,
                moe_cfg=moe_cfg, prompts=prompts)


def test_filter_mesh_2x2_and_dp4_match_the_reference(world4):
    a, prompts = world4["arrays"], world4["prompts"]
    want_single = _ref_filter("max_signatures:8", prompts)
    for name, custom, shape in (("2x2", "mesh:2x2", {"dp": 2, "tp": 2}),
                                ("dp4", "mesh:dp=4", {"dp": 4})):
        want = _ref_filter(custom, prompts)
        for o in world4["outs"]:
            assert o[f"mesh-{name}"] == shape
        for i, p in enumerate(prompts):
            got = a[f"filter-{name}-{i}"]
            assert got.shape == (4, 6 + 8)
            np.testing.assert_array_equal(got[:, :6], p)
            np.testing.assert_array_equal(got, np.asarray(want[i]))
            np.testing.assert_array_equal(got, np.asarray(want_single[i]))


def test_make_sharded_streaming_and_session_match_the_reference(world4):
    from nnstreamer_tpu.models.lm_serving import tiny

    a, p = world4["arrays"], world4["prompts"][0]
    mesh = _ref_mesh({"dp": 2, "tp": 2})
    want = np.asarray(tiny.make_sharded(mesh)(jnp.asarray(p))[0])
    np.testing.assert_array_equal(a["sharded"], want)
    assert world4["outs"][0]["sharded-local-rows"] == 2

    stream = tiny.make_streaming(mesh)
    want = np.stack([np.asarray(t) for t in stream(p, 5)], 1)
    np.testing.assert_array_equal(a["stream"], want)

    session = tiny.make_session(mesh)
    for turn, (q, steps) in enumerate(((p, 4),
                                       (world4["data"]["turn2"], 3))):
        want = np.stack([np.asarray(t) for t in session.generate(q, steps)],
                        1)
        np.testing.assert_array_equal(a[f"session-{turn}"], want)
    for o in world4["outs"]:
        assert o["session-position"] == session.position


def test_tensor_generate_mesh_2x2_matches_the_reference(world4):
    a, p = world4["arrays"], world4["prompts"][0]
    bufs = _ref_launch(
        _caps(p) + "! tensor_generate "
        "model=nnstreamer_tpu.models.lm_serving:tiny steps=5 mesh=2x2 "
        "! tensor_sink name=out max-stored=16", [p])
    want = np.concatenate(bufs, axis=1)
    assert a["generate-elem"].shape == (4, 5)
    np.testing.assert_array_equal(a["generate-elem"], want)
    assert world4["outs"][0]["generate-mesh"] == {"dp": 2, "tp": 2}


def test_meshed_and_context_parallel_generate_match_the_reference(world4):
    from nnstreamer_tpu.models.decoding import make_generate

    a, d, cfg = world4["arrays"], world4["data"], world4["dec_cfg"]
    params = jax.tree_util.tree_map(jnp.asarray, d["dec"].item())
    mesh = _ref_mesh({"dp": 2, "tp": 2})
    want = np.asarray(make_generate(cfg, mesh=mesh)(
        _ref_sharded(cfg, params, mesh), jnp.asarray(d["p_mesh"]), 5))
    np.testing.assert_array_equal(a["dp2tp2"], want)
    plain = np.asarray(make_generate(cfg)(params, jnp.asarray(d["p_cp"]), 6))
    for name, sizes in (("cp-dp2sp2", {"dp": 2, "tp": 1, "sp": 2}),
                        ("cp-tp2sp2", {"dp": 1, "tp": 2, "sp": 2}),
                        ("cp-sp4", {"dp": 1, "tp": 1, "sp": 4})):
        mesh = _ref_mesh(sizes)
        want = np.asarray(make_generate(cfg, mesh=mesh,
                                        context_parallel=True)(
            _ref_sharded(cfg, params, mesh), jnp.asarray(d["p_cp"]), 6))
        np.testing.assert_array_equal(want, plain)
        np.testing.assert_array_equal(a[name], want, err_msg=name)


def test_moe_filter_with_an_indivisible_batch_matches_the_reference(world4):
    """dp=4 over a batch of 6 runs whole on every rank (the reference's
    fallback): the MoE capacity counts the batch once, as unmeshed."""
    from nnstreamer_tpu.models.decoding import make_generate
    from nnstreamer_tpu.models.lm_serving import tiny

    d = world4["data"]
    params = jax.tree_util.tree_map(jnp.asarray, d["tiny_moe"].item())
    want = np.asarray(make_generate(replace(tiny.cfg, moe_experts=4))(
        params, jnp.asarray(d["p6"]), 8))
    got = world4["arrays"]["moe-indivisible"]
    assert got.shape == (6, 13)
    np.testing.assert_array_equal(got, want)


def test_moe_generate_on_a_dp_tp_mesh_matches_the_reference(world4):
    from nnstreamer_tpu.models.decoding import make_generate

    a, d, cfg = world4["arrays"], world4["data"], world4["moe_cfg"]
    params = jax.tree_util.tree_map(jnp.asarray, d["moe"].item())
    mesh = _ref_mesh({"dp": 2, "tp": 2})
    want = np.asarray(make_generate(cfg, mesh=mesh)(
        _ref_sharded(cfg, params, mesh), jnp.asarray(d["p_moe"]), 4))
    assert a["moe"].shape == (2, 7)
    np.testing.assert_array_equal(a["moe"], want)


def test_context_parallel_errors_are_the_reference_s(world4):
    from nnstreamer_tpu.models.decoding import make_generate
    from nnstreamer_tpu.models.transformer import TransformerConfig

    o = world4["outs"][0]
    with pytest.raises(ValueError) as want:
        make_generate(world4["dec_cfg"], context_parallel=True)
    assert o["err-no-mesh"] == str(want.value)
    bad = TransformerConfig(vocab=8, dim=8, heads=2, layers=1, max_seq=7)
    with pytest.raises(ValueError) as want:
        make_generate(bad, mesh=_ref_mesh({"dp": 1, "tp": 2, "sp": 2}),
                      context_parallel=True)
    assert "divide" in o["err-divide"]
    assert o["err-divide"] == str(want.value)
    assert "'sp' axis" in o["err-no-sp"]


def test_heads_not_divisible_by_tp_posts_the_reference_error(tmp_path):
    from nnstreamer_tpu.core import MessageType
    from nnstreamer_tpu.models.lm_serving import tiny
    from nnstreamer_tpu.models.transformer import init_params
    from nnstreamer_tpu.runtime.parse import parse_launch

    p = np.zeros((4, 6), np.int32)
    outs, _ = spawn_world(tmp_path, WORKER, "heads3", 3, dict(
        tiny=pytree(init_params(tiny.cfg, seed=0)), p0=p, p1=p))
    pipe = parse_launch(
        _caps(p) + "! tensor_filter framework=jax "
        "model=nnstreamer_tpu.models.lm_serving:tiny custom=mesh:1x3 "
        "! tensor_sink name=out")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=30)
    pipe.stop()
    want = str(msg.data.get("error", ""))
    assert "not divisible" in want
    for o in outs:
        assert o["error"] is not None and "not divisible" in o["error"]
        assert "heads=4 not divisible by mesh tp=3" in o["error"]
        assert "heads=4 not divisible by mesh tp=3" in want
