"""Tensor-parallel LM serving inside a pipeline, on the port: the
counterpart of ``examples/serve_lm_pipeline.py``.

One launch line serves batched greedy generation through
``tensor_filter framework=torch
model=nnstreamer_tpu_torch.models.lm_serving:<entry> custom=mesh:DxT``:
SPMD over ``torch.distributed``, every rank runs the same line, the
parameters Megatron-sharded over ``tp`` and the batch over ``dp``; the
decode and prefill attention run through the hand-written kernels on each
rank's heads. The streaming form (``tensor_generate ... mesh=DxT``) emits
one buffer per decoded token and gives the same tokens.

    python examples/serve_lm_pipeline_torch.py              # base, mesh:1x1
    python examples/serve_lm_pipeline_torch.py --device cpu --config tiny \\
        --world 8                                           # mesh:2x4, gloo

On one card the mesh is ``1x1`` on a world-1 NCCL group; ``--world N``
spawns N ranks (one per card; gloo with ``--device cpu``) and the mesh
is ``2x4`` for 8, ``Nx1`` for a world 4 does not divide.
Weights are the entry's seeded init unless ``--params`` names a ``.npz``
whose ``params`` entry is nnstreamer_tpu's parameter pytree.
``--prompts`` (a ``.npy`` of (R, B, P) int32 requests) replaces the
reference's two (4, 6) batches; ``--out DIR`` writes each rank's summary
and rank 0's tokens. The filter line generates the entry's default steps
(``tiny`` 8, ``base`` 64; ``NNS_LM_STEPS`` overrides).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_world as W  # noqa: E402

ENTRY = "nnstreamer_tpu_torch.models.lm_serving"
# the entry carrying --params, named by the launch lines as __main__:LM
LM = None


def default_mesh(world: int) -> str:
    tp = 4 if world % 4 == 0 else (2 if world % 2 == 0 else 1)
    return f"{world // tp}x{tp}"


def launch(line: str, pushes, on_buffer):
    """Play ``line``, push every request, wait for EOS; return the
    element named ``f``'s mesh."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(line)
    pipe.get("out").connect(on_buffer)
    pipe.play()
    try:
        src = pipe.get("in")
        for p in pushes:
            src.push_buffer(p)
        src.end_of_stream()
        msg = pipe.wait(timeout=600)
        f = pipe.get("f")
        mesh = getattr(f, "backend_mesh", None) or getattr(f, "mesh", None)
    finally:
        pipe.stop()
    if msg is None or msg.type is not MessageType.EOS:
        raise RuntimeError(f"pipeline ended without EOS: {msg}")
    return mesh


def counts() -> dict:
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    return {"decode_attention": decode_attention.launches,
            "flash_attention": flash_attention.launches}


def reset_counts() -> None:
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    decode_attention.launches = 0
    flash_attention.launches = 0


def run(args, dev) -> None:
    global LM
    from nnstreamer_tpu_torch.models import lm_serving

    W.init_world(dev)
    world = torch.distributed.get_world_size()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    acc = W.accelerator(dev)
    mesh_spec = default_mesh(world)
    data = W.load_data(args.params)
    if "params" in data:
        LM = replace(getattr(lm_serving, args.config), params=data["params"])
        model = "__main__:LM"
    else:
        model = f"{ENTRY}:{args.config}"
    if args.prompts:
        requests = list(np.load(args.prompts).astype(np.int32))
    else:
        rng = np.random.default_rng(0)
        requests = [rng.integers(0, 64, (4, 6)).astype(np.int32)
                    for _ in range(2)]
    B, P = requests[0].shape
    caps = ("appsrc name=in caps=other/tensors,format=static,"
            f"dimensions={P}:{B},types=int32 ")
    is_rank0 = W.rank() == 0

    outs = []
    reset_counts()
    mesh = launch(caps + f"! tensor_filter framework=torch model={model} "
                  f"accelerator={acc} custom=mesh:{mesh_spec} name=f "
                  f"! tensor_sink name=out max-stored={len(requests)}",
                  requests, lambda b: outs.append(
                      np.asarray(b.as_numpy().tensors[0])))
    filter_launches = counts()
    shape = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))
    if is_rank0:
        print(f"mesh: {shape} (custom=mesh:{mesh_spec}, world {world} on "
              f"{dev}); model {model}")
        for i, arr in enumerate(outs):
            print(f"batch {i}: prompt {arr[0, :P].tolist()[:8]} -> "
                  f"generated {arr[0, P:].tolist()[:16]} (over "
                  f"{world} rank(s))")
        print("filter launches: " + json.dumps(filter_launches), flush=True)

    steps = args.stream_steps
    stream = []

    def on_token(b):
        stream.append(np.asarray(b.as_numpy().tensors[0])[:, 0])
        if is_rank0:
            print(f"  token {b.meta['gen_step']}: "
                  f"{stream[-1].tolist()[:8]}"
                  + ("  <last>" if b.meta["gen_last"] else ""))

    reset_counts()
    if is_rank0:
        print("streaming generation (one buffer per token as it decodes):")
    smesh = launch(caps + f"! tensor_generate name=f model={model} "
                   f"accelerator={acc} steps={steps} mesh={mesh_spec} "
                   f"! tensor_sink name=out max-stored={steps}",
                   requests[:1], on_token)
    stream_launches = counts()
    stream_tokens = np.stack(stream, 1)
    if is_rank0:
        print("stream launches: " + json.dumps(stream_launches), flush=True)
        same = np.array_equal(stream_tokens,
                              outs[0][:, P:P + steps])
        print(f"streamed {stream_tokens.shape[1]} tokens; equal to the "
              f"filter line's first {steps}: {same}")
    W.write_rank(args.out, {
        "mesh": shape, "stream_mesh": dict(zip(
            smesh.mesh_dim_names, map(int, smesh.shape))),
        "filter_launches": filter_launches,
        "stream_launches": stream_launches, "device": str(dev)},
        {"filter": np.stack(outs), "stream": stream_tokens})
    W.close_world()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--config", choices=("tiny", "base"), default="base")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to spawn (one per card; gloo on the CPU)")
    ap.add_argument("--stream-steps", type=int, default=8)
    ap.add_argument("--params", help=".npz with nnstreamer_tpu's pytree "
                    "under 'params' (default: the entry's seeded init)")
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
