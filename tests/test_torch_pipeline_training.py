"""Mirror of nnstreamer_tpu's ``tests/test_pipeline_training.py``: GPipe
pipeline-parallel training (``parallel/pipeline.py``) against the
reference on the same stage parameters, microbatches and targets (drawn
by JAX's PRNG, as the reference suite draws them).

The port runs SPMD, one process per stage, on a 4-process gloo world
(``tests/test_torch_mesh_serving.py::spawn_world``); the reference runs
the same 4-stage pipeline on 4 of its virtual CPU devices. The reference
suite's mesh is pp4×dp2; the dp axis only splits each microbatch, so the
4-stage world holds the same schedule at half the processes.

Cases the port already held: ``test_matches_sequential`` and
``test_single_microbatch_and_many`` are
``tests/test_torch_parallel.py::test_world4_context_attention_and_pipeline``
(the 4-stage pipeline's outputs for M = 1, 6, 9 within 1e-5 of the
reference's, and its gradients); five SGD steps of the pp4×dp2 pipeline are
``test_world8_train_parallel_example_matches_reference``. Here: the stage
count that does not match the ``pp`` axis is refused with the same error
type, and twelve SGD steps give the reference's losses (within 5e-5, the
parallel suite's loss bound) with gradient reaching every stage at every
step and the loss falling below 0.9 of its start on both sides."""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_mesh_serving import spawn_world

P_STAGES = 4
DIM = 8
STEPS = 12
LR = 0.5

WORKER = textwrap.dedent(r'''
    import json, os, sys
    sys.path.insert(0, os.environ["NNS_REPO"])
    for name in ("jax", "jaxlib", "flax", "optax", "nnstreamer_tpu"):
        sys.modules[name] = None
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from nnstreamer_tpu_torch.parallel import init_multihost, make_mesh
    from nnstreamer_tpu_torch.parallel.pipeline import (
        make_pipeline, stack_stage_params)

    job, data_path, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    data = dict(np.load(data_path))
    assert init_multihost()
    rank = dist.get_rank()
    mesh = make_mesh(None, {"pp": 4})

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    out = {}
    try:
        make_pipeline(stage_fn, 5, mesh)
        out["mismatch"] = None
    except Exception as e:  # the refusal's type is compared
        out["mismatch"] = type(e).__name__
    run = make_pipeline(stage_fn, 4, mesh)
    stacked = stack_stage_params([
        {"w": torch.from_numpy(data["w"][i]), "b": torch.from_numpy(data["b"][i])}
        for i in range(4)])
    xs, target = torch.from_numpy(data["xs"]), torch.from_numpy(data["target"])
    losses, gnorms = [], []
    for _ in range(int(data["steps"])):
        leaves = {k: v.detach().requires_grad_(True) for k, v in stacked.items()}
        loss = ((run(leaves, xs) - target) ** 2).mean()
        g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        gnorms.append(g["w"].pow(2).sum(dim=(1, 2)).sqrt().tolist())
        stacked = {k: (v - float(data["lr"]) * g[k]).detach()
                   for k, v in leaves.items()}
        losses.append(float(loss.detach()))
    out["losses"], out["gnorms"] = losses, gnorms
    with open(os.path.join(out_dir, f"out{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()   # no rank tears its group down under a peer's last op
    dist.destroy_process_group()
''')


def _stage_params(key):
    k1, k2 = jax.random.split(key)
    return {
        "w": jax.random.normal(k1, (DIM, DIM), jnp.float32) * 0.5,
        "b": jax.random.normal(k2, (DIM,), jnp.float32) * 0.1,
    }


def _inputs():
    keys = jax.random.split(jax.random.PRNGKey(3), P_STAGES)
    params = [_stage_params(k) for k in keys]
    xs = jax.random.normal(jax.random.PRNGKey(4), (4, 2, DIM))
    target = jax.random.normal(jax.random.PRNGKey(5), (4, 2, DIM)) * 0.3
    return params, xs, target


def _reference():
    from nnstreamer_tpu.parallel.mesh import make_mesh
    from nnstreamer_tpu.parallel.pipeline import (make_pipeline,
                                                  stack_stage_params)

    params, xs, target = _inputs()
    mesh = make_mesh(jax.devices()[:P_STAGES], {"pp": P_STAGES})
    try:
        make_pipeline(lambda p, x: x, P_STAGES + 1, mesh)
        mismatch = None
    except Exception as e:  # noqa: BLE001 - the refusal's type is compared
        mismatch = type(e).__name__
    run = make_pipeline(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                        P_STAGES, mesh)
    stacked = stack_stage_params(params)
    step = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean((run(p, xs) - target) ** 2)))
    losses, gnorms = [], []
    for _ in range(STEPS):
        loss, grads = step(stacked)
        gnorms.append(np.asarray(jnp.sqrt(jnp.sum(grads["w"] ** 2,
                                                  axis=(1, 2)))).tolist())
        stacked = jax.tree_util.tree_map(lambda p, g: p - LR * g, stacked,
                                         grads)
        losses.append(float(loss))
    return {"mismatch": mismatch, "losses": losses, "gnorms": gnorms}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params, xs, target = _inputs()
    data = dict(w=np.stack([np.asarray(p["w"]) for p in params]),
                b=np.stack([np.asarray(p["b"]) for p in params]),
                xs=np.asarray(xs), target=np.asarray(target),
                steps=np.int32(STEPS), lr=np.float32(LR))
    outs, _ = spawn_world(tmp_path_factory.mktemp("gpipe"), WORKER, "gpipe",
                          P_STAGES, data)
    return _reference(), outs


def test_stage_count_must_match_axis(worlds):
    ref, outs = worlds
    assert ref["mismatch"] == "ValueError"
    assert all(o["mismatch"] == ref["mismatch"] for o in outs)


def test_grads_flow_and_loss_decreases(worlds):
    ref, outs = worlds
    for side in [ref] + outs:
        assert (np.asarray(side["gnorms"]) > 0).all()     # no dead stage
        assert side["losses"][-1] < side["losses"][0] * 0.9
    for o in outs:   # every rank holds the same replicated loss
        np.testing.assert_allclose(o["losses"], ref["losses"], atol=5e-5,
                                   rtol=0)
        np.testing.assert_allclose(o["gnorms"], ref["gnorms"], atol=1e-4,
                                   rtol=1e-3)
