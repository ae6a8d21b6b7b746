"""The port's parallel layer (nnstreamer_tpu_torch/parallel/, and the
meshed train step of models/transformer.py) against nnstreamer_tpu's on
its 8 virtual CPU devices.

The port runs SPMD, one process per rank: each test spawns a gloo world
of 2, 4 or 8 processes on 127.0.0.1 (a port of its own, a time limit, and
every process killed on the way out), feeds it the JAX package's weights
and inputs through an .npz file and reads back each rank's results.

* the 8-rank world runs ``examples/train_parallel_torch.py``'s own steps
  (its ``run()`` on the world): five dp2×tp2×sp2 steps of the ring + MoE
  LM (and of the gspmd and ulysses forms), and five SGD steps through the
  pp4×dp2 GPipe pipeline, against the same steps of the reference
  (``examples/train_parallel.py``); ring attention at sp=8 against dense;
* the 4-rank world: ring, Ulysses and gathered attention over sp=4
  (outputs and input gradients) against dense attention, the 4-stage
  pipeline's outputs (M = 1, 6, 9) and gradients against the reference's,
  and ``make_mesh``'s axis order;
* the 2-rank world: ``init_multihost`` from ``NNS_COORD`` /
  ``NNS_NUM_PROCS`` / ``NNS_PROC_ID``, ``process_info``, ``global_mesh``.

Tolerances: attention outputs and gradients within 2e-5 absolute and
2e-4 relative (the reference's own bound for its context attention);
losses within 5e-5 absolute over five steps and parameters within 5e-5
absolute and 1e-3 relative (the ranks sum partial products in other
orders than XLA); pipeline outputs within 1e-5 absolute."""
import json
import os
import subprocess
import sys
import textwrap

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
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from nnstreamer_tpu_torch.parallel import (
        factor_devices, global_mesh, init_multihost, make_context_attention,
        make_mesh, process_info)
    from nnstreamer_tpu_torch.parallel.pipeline import (
        make_pipeline, stack_stage_params)
    from nnstreamer_tpu_torch.models import transformer as T
    from nnstreamer_tpu_torch.models.convert import params_from_jax

    job, data_path, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    data = dict(np.load(data_path, allow_pickle=True))
    assert init_multihost()
    rank = dist.get_rank()
    out = {}
    arrays = {}

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return [kv for k in sorted(tree) for kv in flat(tree[k], f"{prefix}{k}.")]
        if isinstance(tree, list):
            return [kv for i, t in enumerate(tree) for kv in flat(t, f"{prefix}{i}.")]
        return [(prefix[:-1], tree)]

    def tree_from(prefix):
        return data[prefix].item()

    def local_block(x, mesh):
        # (B, H, S, D) global → this rank's sp block
        return x.chunk(mesh.size(mesh.mesh_dim_names.index("sp")), 2)[
            mesh.get_local_rank("sp")].contiguous()

    def gather_seq(x, mesh):
        group = mesh.get_group("sp")
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 2)

    def attention_checks(mesh, q, k, v, cot, impls, causals, tag):
        for impl in impls:
            for causal in causals:
                qs, ks, vs = (local_block(torch.from_numpy(a), mesh)
                              .requires_grad_(True) for a in (q, k, v))
                attn = make_context_attention(mesh, impl=impl, causal=causal)
                o = attn(qs, ks, vs)
                (o * local_block(torch.from_numpy(cot), mesh)).sum().backward()
                name = f"{tag}-{impl}-{int(causal)}"
                arrays[name] = gather_seq(o.detach(), mesh).numpy()
                for g, n in ((qs, "dq"), (ks, "dk"), (vs, "dv")):
                    arrays[f"{name}-{n}"] = gather_seq(g.grad, mesh).numpy()

    def pipeline_run(mesh, stages, xs_list, target=None, steps=0, lr=0.0):
        def stage_fn(p, x):
            return torch.tanh(x @ p["w"] + p["b"]) if "b" in p else torch.tanh(x @ p["w"])
        run = make_pipeline(stage_fn, len(stages), mesh)
        stacked = stack_stage_params(
            [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages])
        outs = [run(stacked, torch.from_numpy(xs)).numpy() for xs in xs_list]
        losses, grads = [], None
        for i in range(steps):
            leaves = {k: v.detach().requires_grad_(True) for k, v in stacked.items()}
            ys = run(leaves, torch.from_numpy(xs_list[0]))
            loss = (((ys - torch.from_numpy(target)) ** 2).mean() if target is not None
                    else (ys ** 2).mean())
            g = torch.autograd.grad(loss, list(leaves.values()))
            if i == 0:
                grads = {k: gi.numpy() for k, gi in zip(leaves, g)}
            stacked = {k: (v - lr * gi).detach()
                       for (k, v), gi in zip(leaves.items(), g)}
            losses.append(float(loss.detach()))
        return outs, losses, grads

    if job == "world8":
        # the steps are examples/train_parallel_torch.py's own: its run()
        # on this world, the LM steps for all three attention forms
        import argparse, runpy
        script = runpy.run_path(os.path.join(
            os.environ["NNS_REPO"], "examples", "train_parallel_torch.py"),
            run_name="train_parallel_torch")
        got, got_arrays = script["run"](
            argparse.Namespace(params=data_path), torch.device("cpu"),
            impls=("ring", "gspmd", "ulysses"))
        out.update(got)
        arrays.update(got_arrays)
        out["axes"] = list(make_mesh(None, {"tp": 2, "dp": 2, "sp": 2})
                           .mesh_dim_names)
        mesh8 = make_mesh(None, {"dp": 1, "tp": 1, "sp": 8})
        attention_checks(mesh8, data["q8"], data["k8"], data["v8"],
                         data["cot8"], ("ring",), (True,), "sp8")
    elif job == "world4":
        mesh = make_mesh(None, {"dp": 1, "tp": 1, "sp": 4})
        out["axes"] = list(mesh.mesh_dim_names)
        attention_checks(mesh, data["q"], data["k"], data["v"], data["cot"],
                         ("ring", "ulysses", "gspmd"), (True, False), "sp4")
        mesh_pp = make_mesh(None, {"pp": 4})
        stages = [{"w": w, "b": b} for w, b in zip(data["st_w"], data["st_b"])]
        outs, losses, grads = pipeline_run(
            mesh_pp, stages, [data["xs6"], data["xs1"], data["xs9"]],
            target=data["target"], steps=1)
        for name, o in zip(("xs6", "xs1", "xs9"), outs):
            arrays[f"pp-{name}"] = o
        arrays["pp-grad-w"], arrays["pp-grad-b"] = grads["w"], grads["b"]
        out["pp-loss"] = losses[0]
        # dict order never overrides dp-outermost
        out["reordered"] = list(make_mesh(None, {"tp": 2, "dp": 2}).mesh_dim_names)
        out["custom"] = list(make_mesh(None, {"ep": 2, "dp": 2}).mesh_dim_names)
    elif job == "world2":
        out["info"] = process_info()
        mesh = global_mesh()
        out["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x)
        out["sum"] = float(x)
        out["backend"] = dist.get_backend()
    dist.barrier()
    with open(os.path.join(out_dir, f"out{rank}.json"), "w") as fh:
        json.dump(out, fh)
    if arrays and rank == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)
    dist.destroy_process_group()
''')


def _spawn(tmp_path, job, n, data, timeout_s=150):
    """Run the worker's ``job`` in an ``n``-process gloo world; return
    each rank's JSON and rank 0's arrays."""
    prog = tmp_path / "worker.py"
    prog.write_text(WORKER)
    data_path = tmp_path / "data.npz"
    np.savez(data_path, **data)
    env = dict(os.environ, NNS_REPO=ROOT, NNS_COORD=f"file://{tmp_path / 'store'}",
               NNS_NUM_PROCS=str(n), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, str(prog), job, str(data_path), str(tmp_path)],
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


def _dense_attention(q, k, v, causal):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        S = q.shape[2]
        scores = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None],
                           scores, -1e30)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(scores, -1), v)


def _check_attention(arrays, tag, impls, causals, q, k, v, cot):
    for impl in impls:
        for causal in causals:
            name = f"{tag}-{impl}-{int(causal)}"
            want, vjp = jax.vjp(lambda a, b, c: _dense_attention(a, b, c, causal),
                                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            np.testing.assert_allclose(arrays[name], np.asarray(want),
                                       rtol=2e-4, atol=2e-5, err_msg=name)
            for g, n in zip(vjp(jnp.asarray(cot)), ("dq", "dk", "dv")):
                np.testing.assert_allclose(arrays[f"{name}-{n}"], np.asarray(g),
                                           rtol=2e-4, atol=2e-5,
                                           err_msg=f"{name}-{n}")


def _qkv(B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(4)]


def _reference_lm_steps(impl, heads, tree, toks):
    from nnstreamer_tpu.models.transformer import TransformerConfig, make_train_step
    from nnstreamer_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices(), {"dp": 2, "tp": 2, "sp": 2})
    cfg = TransformerConfig(vocab=64, dim=32, heads=heads, layers=2,
                            max_seq=17, attn_impl=impl, moe_experts=4)
    step, shard_params, data_sharding = make_train_step(cfg, mesh, lr=3e-2)
    params = shard_params(jax.tree_util.tree_map(jnp.asarray, tree))
    t = jax.device_put(toks, data_sharding)
    losses = []
    for _ in range(5):
        params, loss = step(params, t)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


def test_world8_train_parallel_example_matches_reference(tmp_path):
    """``examples/train_parallel.py`` in the port, run by its twin
    ``examples/train_parallel_torch.py`` on an 8-rank world: the
    dp2×tp2×sp2 ring + MoE step (and the gspmd and Ulysses forms) and the
    pp4×dp2 GPipe step, five steps each, against the reference on its 8
    virtual devices."""
    from nnstreamer_tpu.models.transformer import TransformerConfig, init_params
    from nnstreamer_tpu.parallel import make_mesh
    from nnstreamer_tpu.parallel.pipeline import make_pipeline, stack_stage_params

    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(np.asarray, init_params(
        TransformerConfig(vocab=64, dim=32, heads=2, layers=2, max_seq=17,
                          moe_experts=4)))
    toks = rng.integers(0, 64, (4, 17)).astype(np.int32)
    pp_w = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(i),
                                                  (16, 16)) * 0.3)
                     for i in range(4)])
    pp_xs = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (4, 2, 16)))
    q8, k8, v8, cot8 = _qkv(1, 2, 128, 16, 1)
    params_obj = np.empty((), dtype=object)
    params_obj[()] = tree
    outs, arrays = _spawn(tmp_path, "world8", 8, dict(
        params=params_obj, tokens=toks, pp_w=pp_w, pp_xs=pp_xs,
        q8=q8, k8=k8, v8=v8, cot8=cot8), timeout_s=160)
    assert outs[0]["axes"] == ["dp", "tp", "sp"]

    for impl, heads in (("ring", 2), ("gspmd", 4), ("ulysses", 4)):
        want, final = _reference_lm_steps(impl, heads, tree, toks)
        for o in outs:   # every rank reports the global loss
            np.testing.assert_allclose(o[f"losses-{impl}"], want, atol=5e-5,
                                       rtol=0, err_msg=impl)
        assert want[-1] < want[0]
        for path, leaf in jax.tree_util.tree_flatten_with_path(final)[0]:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            np.testing.assert_allclose(arrays[f"params-{impl}-{name}"], leaf,
                                       atol=5e-5, rtol=1e-3,
                                       err_msg=f"{impl} {name}")

    mesh_pp = make_mesh(jax.devices(), {"pp": 4, "dp": 2})
    run = make_pipeline(lambda p, x: jnp.tanh(x @ p["w"]), 4, mesh_pp)
    stacked = stack_stage_params([{"w": jnp.asarray(w)} for w in pp_w])
    grad_step = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean(run(p, jnp.asarray(pp_xs)) ** 2)))
    losses = []
    for i in range(5):
        loss, grads = grad_step(stacked)
        if i == 0:
            np.testing.assert_allclose(arrays["pp_grad_w"],
                                       np.asarray(grads["w"]), atol=1e-6,
                                       rtol=1e-4)
        stacked = jax.tree_util.tree_map(lambda p, g: p - 0.3 * g, stacked,
                                         grads)
        losses.append(float(loss))
    for o in outs:
        np.testing.assert_allclose(o["pp_losses"], losses, atol=1e-6, rtol=1e-5)

    _check_attention(arrays, "sp8", ("ring",), (True,), q8, k8, v8, cot8)


def test_world4_context_attention_and_pipeline(tmp_path):
    from nnstreamer_tpu.parallel import make_mesh
    from nnstreamer_tpu.parallel.pipeline import make_pipeline, stack_stage_params

    q, k, v, cot = _qkv(2, 4, 32, 8, 0)
    rng = np.random.default_rng(3)
    st_w = (rng.standard_normal((4, 8, 8)) * 0.5).astype(np.float32)
    st_b = (rng.standard_normal((4, 8)) * 0.1).astype(np.float32)
    xs = {m: rng.standard_normal((m, 2, 8)).astype(np.float32)
          for m in (6, 1, 9)}
    target = (rng.standard_normal((6, 2, 8)) * 0.3).astype(np.float32)
    outs, arrays = _spawn(tmp_path, "world4", 4, dict(
        q=q, k=k, v=v, cot=cot, st_w=st_w, st_b=st_b, xs6=xs[6], xs1=xs[1],
        xs9=xs[9], target=target))
    assert outs[0]["axes"] == ["dp", "tp", "sp"]
    assert outs[0]["reordered"] == ["dp", "tp"]
    assert outs[0]["custom"] == ["dp", "ep"]
    _check_attention(arrays, "sp4", ("ring", "ulysses", "gspmd"),
                     (True, False), q, k, v, cot)

    mesh = make_mesh(jax.devices()[:4], {"pp": 4})
    run = make_pipeline(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), 4, mesh)
    stacked = stack_stage_params([{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                                  for w, b in zip(st_w, st_b)])
    for m in (6, 1, 9):
        np.testing.assert_allclose(arrays[f"pp-xs{m}"],
                                   np.asarray(jax.jit(run)(stacked,
                                                           jnp.asarray(xs[m]))),
                                   atol=1e-5, rtol=0)
    loss, grads = jax.value_and_grad(
        lambda p: jnp.mean((run(p, jnp.asarray(xs[6])) - target) ** 2))(stacked)
    assert abs(outs[0]["pp-loss"] - float(loss)) <= 1e-6
    for n in ("w", "b"):
        g = np.asarray(grads[n])
        assert (np.abs(g).reshape(4, -1).sum(1) > 0).all()   # no dead stage
        np.testing.assert_allclose(arrays[f"pp-grad-{n}"], g, atol=1e-6,
                                   rtol=1e-4)


def test_world2_multihost_bootstrap(tmp_path):
    outs, _ = _spawn(tmp_path, "world2", 2, dict(unused=np.zeros(1)))
    for rank, o in enumerate(outs):
        assert o["info"] == {"process_index": rank, "process_count": 2,
                             "local_devices": 1, "global_devices": 2}
        assert o["mesh_shape"] == {"dp": 2, "tp": 1, "sp": 1}
        assert o["sum"] == 3.0
        assert o["backend"] == "gloo"


def test_factor_devices_matches_reference():
    from nnstreamer_tpu.parallel.mesh import factor_devices as ref
    from nnstreamer_tpu_torch.parallel import factor_devices

    for n in range(1, 33):
        assert factor_devices(n) == ref(n), n
    assert factor_devices(8) == {"dp": 2, "tp": 2, "sp": 2}
    assert factor_devices(12, ("pp", "dp")) == ref(12, ("pp", "dp"))


def test_single_process_multihost_is_a_noop(monkeypatch):
    from nnstreamer_tpu_torch.parallel import init_multihost, process_info

    for name in ("NNS_COORD", "NNS_NUM_PROCS", "NNS_PROC_ID"):
        monkeypatch.delenv(name, raising=False)
    assert init_multihost() is False
    assert process_info() == {"process_index": 0, "process_count": 1,
                              "local_devices": 1, "global_devices": 1}
    monkeypatch.setenv("NNS_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="partial distributed config"):
        init_multihost()


def test_sharded_runner_splits_the_batch_over_replicas():
    import torch
    from nnstreamer_tpu_torch.parallel import ShardedRunner

    runner = ShardedRunner(lambda x: x * 2 + 1, devices=["cpu"] * 8)
    batch = np.arange(16, dtype=np.float32).reshape(16, 1)
    out = runner(batch)
    np.testing.assert_array_equal(out.numpy(), batch * 2 + 1)
    assert runner.batch_divisor == 8
    with pytest.raises(ValueError, match="not divisible"):
        runner(np.zeros((3, 2), np.float32))
    blocks = []
    runner = ShardedRunner(lambda x: blocks.append(x.tolist()) or x,
                           devices=["cpu", "cpu"])
    np.testing.assert_array_equal(runner(torch.arange(4.0)).numpy(),
                                  [0, 1, 2, 3])
    assert blocks == [[0, 1], [2, 3]]
