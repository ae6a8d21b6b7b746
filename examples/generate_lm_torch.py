"""Autoregressive text generation with a KV cache, on the port: the
counterpart of ``examples/generate_lm.py``.

Runs nnstreamer_tpu_torch's inference path (``models/decoding.py``): the
prefill fills the per-layer K/V cache through the flash-attention kernel
(``csrc/flash_attention.cu``), then each step decodes one token against
the cache through the cached-decode kernel (``csrc/decode_attention.cu``).
On one card it runs meshless; with ``--world N`` it runs as N processes
(one per card; gloo ranks with ``--device cpu``), the batch split over
``dp`` and the heads over ``tp`` as in the reference's mesh.

    python examples/generate_lm_torch.py                    # base, cuda:0
    python examples/generate_lm_torch.py --device cpu --config tiny
    python examples/generate_lm_torch.py --device cpu --config tiny --world 4

``--config base`` is ``models/lm_serving.py``'s ``base`` (vocab 32000, dim
1024, 16×64 heads, 12 layers, max_seq 2048); ``tiny`` is the reference
script's (vocab 64, dim 64, 4 heads, 2 layers, max_seq 48). Weights are
the port's seeded init (seed 0) unless ``--params`` names a ``.npz`` whose
``params`` entry is nnstreamer_tpu's parameter pytree.

Where it differs from the reference's script: it decodes greedily by
default. The reference samples at temperature 0.8 from
``jax.random.PRNGKey(42)``, a stream no ``torch.Generator`` reproduces;
``--temperature T`` samples from a ``torch.Generator`` seeded with
``--seed``, so sampled tokens are not the reference's. ``--prompts`` (a
``.npy`` of R requests, (R, B, P) int32) replaces the reference's prompt
and ``--out DIR`` writes each rank's summary and rank 0's tokens.

The line before the tokens gives both kernels' launches on this run (0 on
the CPU, where the wrappers run their plain versions).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_world as W  # noqa: E402

TINY = dict(vocab=64, dim=64, heads=4, layers=2, max_seq=48)


def config(name: str):
    from dataclasses import replace

    from nnstreamer_tpu_torch.models.lm_serving import base
    from nnstreamer_tpu_torch.models.transformer import TransformerConfig

    if name == "base":
        return replace(base.cfg, decode_attn="kernel", prefill_attn="kernel")
    return TransformerConfig(**TINY, decode_attn="kernel",
                             prefill_attn="kernel")


def mesh_for(world: int):
    """The reference's mesh for ``world`` ranks: dp = world // 2, tp = 2;
    none for one rank."""
    from nnstreamer_tpu_torch.parallel import make_mesh

    if world == 1:
        return None
    if world % 2:
        raise ValueError(f"--world {world}: the mesh is dp x tp with tp = 2, "
                         "so the world must be even (or 1)")
    return make_mesh(None, {"dp": world // 2, "tp": 2})


def generate_all(cfg, params, requests, steps: int, temperature: float,
                 seed: int, mesh, dev) -> np.ndarray:
    """Every request (B, P) → (B, P + steps) tokens, the global batch on
    every rank."""
    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.transformer import shard_params
    from nnstreamer_tpu_torch.parallel import collectives as C
    from nnstreamer_tpu_torch.parallel.mesh import (
        axis_group,
        axis_index,
        axis_size,
    )

    generate = make_generate(cfg, temperature=temperature, mesh=mesh)
    if mesh is not None:
        params = shard_params(cfg, mesh, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    outs = []
    with torch.inference_mode():
        for p in requests:
            prompt = torch.from_numpy(np.ascontiguousarray(p)).to(dev)
            if mesh is not None:
                prompt = prompt.chunk(axis_size(mesh, "dp"))[
                    axis_index(mesh, "dp")].contiguous()
            out = generate(params, prompt, steps, generator=gen)
            if mesh is not None:
                out = C.all_gather_plain(out, axis_group(mesh, "dp"), 0)
            outs.append(out.cpu().numpy())
    return np.stack(outs)


def run(args, dev) -> None:
    from nnstreamer_tpu_torch.models.convert import params_from_jax
    from nnstreamer_tpu_torch.models.transformer import init_params
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    cfg = config(args.config)
    world = int(os.environ.get("NNS_NUM_PROCS", "1"))
    if world > 1:
        W.init_world(dev)
        dev = torch.device("cpu") if dev.type == "cpu" else \
            torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_for(world)
    data = W.load_data(args.params)
    params = (params_from_jax(data["params"], device=dev) if "params" in data
              else init_params(cfg, seed=0, device=dev))
    if args.prompts:
        requests = np.load(args.prompts).astype(np.int32)
    else:
        batch = (world // 2 if world > 1 else 1) * 2
        requests = (np.tile(np.arange(6, dtype=np.int32), (batch, 1))
                    % cfg.vocab)[None]
    decode_attention.launches = 0
    flash_attention.launches = 0
    tokens = generate_all(cfg, params, requests, args.steps,
                          args.temperature, args.seed, mesh, dev)
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    shape = (None if mesh is None
             else dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))))
    if W.rank() == 0:
        print(f"mesh: {shape or 'none (meshless)'} on {dev}; config "
              f"{args.config}; "
              + ("greedy" if args.temperature == 0 else
                 f"temperature {args.temperature}, torch.Generator seed "
                 f"{args.seed}"))
        R, B, P = requests.shape
        print(f"{R} request(s): prompt ({B}, {P}) -> generated "
              f"{tuple(tokens.shape[1:])}")
        print("launches: " + json.dumps(launches), flush=True)
        for row in tokens[0][:2]:
            print("  ", " ".join(str(t) for t in row))
    W.write_rank(args.out, {"mesh": shape, "launches": launches,
                            "device": str(dev)}, {"tokens": tokens})
    if world > 1:
        W.close_world()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--config", choices=("tiny", "base"), default="base")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to spawn (one per card; gloo on the CPU)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (the default); > 0 samples")
    ap.add_argument("--seed", type=int, default=42,
                    help="the sampling torch.Generator's seed")
    ap.add_argument("--params", help=".npz with nnstreamer_tpu's pytree "
                    "under 'params' (default: the port's seeded init)")
    ap.add_argument("--prompts", help=".npy of (R, B, P) int32 requests")
    ap.add_argument("--out", help="directory for out<rank>.json and rank "
                    "0's arrays.npz (tokens)")
    args = ap.parse_args(argv)
    dev = W.device(args.device)
    if args.world > 1 and not W.in_world():
        return W.spawn(os.path.abspath(__file__),
                       sys.argv[1:] if argv is None else list(argv),
                       args.world, dev)
    run(args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
