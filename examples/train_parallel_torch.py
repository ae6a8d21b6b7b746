"""Sharded training on the port: the counterpart of
``examples/train_parallel.py``. The five parallelism families in one
script, SPMD over ``torch.distributed`` (one process per rank):

* dp/tp/sp with ep riding tp: the transformer LM (ring attention over
  ``sp``, an MoE FFN of 4 experts over ``tp``), five SGD steps;
* pp: a GPipe microbatch pipeline of 4 ``tanh(x @ w)`` stages, five
  steps of ``p - 0.3 g`` on the mean square of its output.

    python examples/train_parallel_torch.py --device cpu --world 8
    python examples/train_parallel_torch.py                 # one card

``--world N`` spawns N ranks (gloo with ``--device cpu``, NCCL on the
cards, one process per card); the LM mesh is ``factor_devices(N)``
(dp2×tp2×sp2 for 8, as the reference's) and the pipeline's is pp4×dp(N/4)
when 4 divides N. On one card it runs the world-1 form and says so: a
dp1×tp1×sp1 group of one rank, and the four stages in sequence on that
rank (the loss GPipe computes, without its schedule), since pp4 needs
four ranks.

Weights are the port's seeded init (``torch.Generator``; stage i's weight
from seed i, the microbatches from seed 9) unless ``--params`` names a
``.npz`` with nnstreamer_tpu's ``params`` pytree, ``tokens``, ``pp_w``
and ``pp_xs``; ``--out DIR`` writes each rank's losses and rank 0's final
parameters.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_world as W  # noqa: E402

STEPS = 5
LM = dict(vocab=64, dim=32, layers=2, max_seq=17, moe_experts=4)
# the reference's head counts per attention form (ring keeps 2 heads)
HEADS = {"ring": 2, "gspmd": 4, "ulysses": 4}
PP_STAGES, PP_LR, LM_LR = 4, 0.3, 3e-2


def flat(tree, prefix=""):
    """(dotted name, leaf) pairs in the reference's tree order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flat(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [kv for i, t in enumerate(tree) for kv in flat(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def lm_steps(mesh, impl: str, full_params, tokens: np.ndarray, dev):
    """Five meshed SGD steps of the ring/gspmd/Ulysses + MoE LM; returns
    the global losses and the gathered final parameters."""
    from nnstreamer_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(heads=HEADS[impl], attn_impl=impl, **LM)
    step, shard, sharding = T.make_train_step(cfg, mesh, lr=LM_LR)
    params = shard(full_params(cfg))
    t = sharding(tokens)
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, t)
        losses.append(float(loss))
    return losses, T.gather_params(cfg, mesh, params)


def gpipe_steps(mesh, pp_w: torch.Tensor, pp_xs: torch.Tensor):
    """Five SGD steps through the 4-stage pipeline (over ``mesh``'s pp
    axis, or the stages in sequence without one); returns the losses and
    the first step's weight gradient."""
    from nnstreamer_tpu_torch.parallel.pipeline import (
        make_pipeline,
        stack_stage_params,
    )

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])

    if mesh is not None:
        run = make_pipeline(stage_fn, PP_STAGES, mesh)
    else:
        def run(p, xs):
            for i in range(PP_STAGES):
                xs = stage_fn({"w": p["w"][i]}, xs)
            return xs
    stacked = stack_stage_params([{"w": w} for w in pp_w])
    losses, first_grad = [], None
    for i in range(STEPS):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in stacked.items()}
        loss = (run(leaves, pp_xs) ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if i == 0:
            first_grad = grads[0].detach().cpu().numpy()
        stacked = {k: (v - PP_LR * g).detach()
                   for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
    return losses, first_grad


def run(args, dev, impls=("ring",)) -> tuple:
    """Every rank's part, the LM steps for each attention form of
    ``impls``; returns (summary, rank 0's arrays)."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.models import transformer as T
    from nnstreamer_tpu_torch.models.convert import params_from_jax
    from nnstreamer_tpu_torch.parallel import factor_devices, make_mesh

    W.init_world(dev)
    world = dist.get_world_size()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    data = W.load_data(args.params)

    def full_params(cfg):
        if "params" in data:
            return params_from_jax(data["params"], device=dev)
        return T.init_params(cfg, seed=0, device=dev)

    tokens = (data["tokens"] if "tokens" in data else
              np.random.default_rng(0).integers(0, 64, (4, 17))
              .astype(np.int32))
    sizes = factor_devices(world)
    mesh = make_mesh(None, sizes)
    out = {"world": world, "mesh": dict(zip(mesh.mesh_dim_names,
                                            map(int, mesh.shape))),
           "device": str(dev)}
    arrays = {}
    is_rank0 = dist.get_rank() == 0
    if is_rank0 and world == 1:
        print("world 1 (one rank): the meshes are dp1×tp1×sp1 and no pp; "
              "--world 8 runs the reference's dp2×tp2×sp2 and pp4×dp2")
    for impl in impls:
        losses, final = lm_steps(mesh, impl, full_params, tokens, dev)
        out[f"losses-{impl}"] = losses
        for name, leaf in flat(final):
            arrays[f"params-{impl}-{name}"] = leaf.detach().cpu().numpy()
        if is_rank0:
            for i, loss in enumerate(losses):
                print(f"{'×'.join(f'{a}{n}' for a, n in sizes.items())} "
                      f"{impl}+moe step {i}: loss {loss:.4f}")

    if "pp_w" in data:
        pp_w = torch.from_numpy(data["pp_w"]).to(dev)
        pp_xs = torch.from_numpy(data["pp_xs"]).to(dev)
    else:
        pp_w = torch.stack([
            torch.randn(16, 16, device=dev, generator=torch.Generator(
                device=dev).manual_seed(i)) * 0.3 for i in range(PP_STAGES)])
        pp_xs = torch.randn(4, 2, 16, device=dev, generator=torch.Generator(
            device=dev).manual_seed(9))
    if world % PP_STAGES == 0:
        pp_mesh = make_mesh(None, {"pp": PP_STAGES,
                                   "dp": world // PP_STAGES})
        pp_name = f"pp{PP_STAGES}×dp{world // PP_STAGES} gpipe"
    else:
        pp_mesh = None
        pp_name = f"{PP_STAGES} stages in sequence (world {world} < pp4)"
    losses, grad = gpipe_steps(pp_mesh, pp_w, pp_xs)
    out["pp_losses"] = losses
    out["pp"] = pp_name
    arrays["pp_grad_w"] = grad
    if is_rank0:
        for i, loss in enumerate(losses):
            print(f"{pp_name} step {i}: loss {loss:.4f}")
    return out, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to spawn (one per card; gloo on the CPU)")
    ap.add_argument("--params", help=".npz with nnstreamer_tpu's 'params' "
                    "pytree, 'tokens', 'pp_w' and 'pp_xs'")
    ap.add_argument("--out", help="directory for out<rank>.json and rank "
                    "0's arrays.npz")
    args = ap.parse_args(argv)
    dev = W.device(args.device)
    if args.world > 1 and not W.in_world():
        return W.spawn(os.path.abspath(__file__),
                       sys.argv[1:] if argv is None else list(argv),
                       args.world, dev)
    out, arrays = run(args, dev)
    W.write_rank(args.out, out, arrays)
    W.close_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())
