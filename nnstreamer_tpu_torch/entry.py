"""Entry points that check the port end to end: the counterpart of the
repo's ``__graft_entry__.py``, kept inside the package.

``entry(device=None)`` — the forward of MobileNet-v2 (the reference's
headline pipeline model; random weights from a seed), exported by
``torch.export`` and run on ``device`` (the card unless the caller asks
for the CPU) beside the eager forward on the same input. The two must be
bit-equal: the exported program runs the same ATen ops.

``dryrun_multichip(n)`` — one meshed train step of the transformer LM on
a world of ``n`` ranks (the mesh factored dp ≥ tp ≥ sp as in the
reference), held against the meshless step on the whole batch. It runs
in this process when a world of ``n`` is already up (the caller is one
rank of an SPMD program) or when ``n`` is 1; otherwise it starts ``n``
rank processes (``python -m nnstreamer_tpu_torch.entry multichip N``)
and reaps them. NCCL on the card, gloo on the CPU.

    python -m nnstreamer_tpu_torch.entry              # entry() on cuda:0
    python -m nnstreamer_tpu_torch.entry multichip 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

#: the meshed loss may differ from the meshless one only by summation
#: order (a mean over dp blocks is a sum of per-block sums)
LOSS_RTOL = 1e-5
_READY = "NNS_DRYRUN "


@dataclass
class EntryResult:
    program: "torch.export.ExportedProgram"
    inputs: torch.Tensor
    exported: torch.Tensor   # (B, 1001) logits of the exported program
    eager: torch.Tensor      # (B, 1001) logits of the eager module

    @property
    def bit_equal(self) -> bool:
        return bool(torch.equal(self.exported, self.eager))


def entry(device=None, batch: int = 1, seed: int = 0) -> EntryResult:
    """Export MobileNet-v2's float32 forward and run it beside the eager
    one on a (batch, 224, 224, 3) input drawn from ``seed``."""
    from .models.mobilenet_v2 import build_mobilenet_v2
    from .utils.hw_accel import resolve_device

    dev = resolve_device(device)
    model = build_mobilenet_v2(compute_dtype="float32", device=dev,
                               seed=seed)
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1.0, 1.0, (batch, 224, 224, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        program = torch.export.export(model, (x,))
        exported = program.module()(x)
        eager = model(x)
    return EntryResult(program, x, exported, eager)


def _tiny_lm(n: int):
    """The reference's tiny LM for a world of ``n``: every axis divides
    its mesh dimension."""
    from .models.transformer import TransformerConfig
    from .parallel.mesh import factor_devices

    sizes = factor_devices(n)
    dp, tp, sp = sizes["dp"], sizes["tp"], sizes["sp"]
    dim = max(16 * tp, 32)
    cfg = TransformerConfig(vocab=64, dim=dim,
                            heads=tp * max(1, (dim // 16) // tp),
                            layers=2, max_seq=8 * sp + 1)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * dp, 8 * sp + 1)).astype(np.int32)
    return sizes, cfg, tokens


def _meshed_step(n: int) -> dict:
    """This rank's share of the dry run, inside an initialized world."""
    import torch.distributed as dist

    from .models.transformer import init_params, make_train_step
    from .parallel.mesh import make_mesh, mesh_device

    sizes, cfg, tokens = _tiny_lm(n)
    mesh = make_mesh(None, sizes)
    dev = mesh_device(mesh)
    params = init_params(cfg, seed=0, device=dev)
    step0, _, _ = make_train_step(cfg, None, lr=1e-2)
    _, want = step0(params, torch.from_numpy(tokens).to(dev))
    step, shard, data = make_train_step(cfg, mesh, lr=1e-2)
    _, loss = step(shard(params), data(tokens))
    got, want = float(loss), float(want)
    if not np.isfinite(got):
        raise RuntimeError(f"dryrun_multichip({n}): non-finite loss {got}")
    rel = abs(got - want) / abs(want)
    if rel > LOSS_RTOL:
        raise RuntimeError(
            f"dryrun_multichip({n}): meshed loss {got} vs meshless {want} "
            f"(rel {rel:.3e} > {LOSS_RTOL})")
    return {"world": n, "rank": dist.get_rank(), "backend":
            dist.get_backend(), "mesh": sizes, "batch": int(tokens.shape[0]),
            "seq": int(tokens.shape[1]), "loss": got, "meshless_loss": want,
            "loss_rel_err": rel}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_world(coord: str, n: int, rank: int, device: Optional[str]) -> None:
    import torch.distributed as dist

    cpu = (device is not None and torch.device(device).type == "cpu") \
        or not torch.cuda.is_available()
    kw = {}
    if not cpu:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{coord}", world_size=n,
                            rank=rank, **kw)


def dryrun_multichip(n: int, device: Optional[str] = None,
                     timeout_s: float = 300.0) -> dict:
    """One meshed train step of the tiny LM on a world of ``n``; returns
    rank 0's summary (mesh, losses) and raises if the meshed loss is not
    the meshless one."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"dryrun_multichip({n}): a world of "
                f"{dist.get_world_size()} is already up")
        return _meshed_step(n)
    if n == 1:
        _init_world(f"127.0.0.1:{_free_port()}", 1, 0, device)
        try:
            return _meshed_step(1)
        finally:
            dist.destroy_process_group()
    coord = f"127.0.0.1:{_free_port()}"
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [pkg_parent] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    if device is not None and torch.device(device).type == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, "-m", "nnstreamer_tpu_torch.entry", "multichip",
           str(n), "--coord", coord]
    if device is not None:
        cmd += ["--device", str(device)]
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(rank)], env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:   # a rank stuck in a collective must not outlive us
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"dryrun_multichip({n}) failed:\n"
                           + "\n".join(logs)[-4000:])
    lines = [ln for ln in logs[0].splitlines() if ln.startswith(_READY)]
    return json.loads(lines[-1][len(_READY):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nnstreamer_tpu_torch.entry")
    ap.add_argument("mode", nargs="?", default="entry",
                    choices=["entry", "multichip"])
    ap.add_argument("n", nargs="?", type=int, default=1)
    ap.add_argument("--device", default=None)
    ap.add_argument("--coord", default=None,
                    help="multichip rank: the world's tcp address")
    ap.add_argument("--rank", type=int, default=None,
                    help="multichip rank: this process's rank")
    args = ap.parse_args(argv)
    if args.mode == "entry":
        r = entry(args.device)
        print(f"entry forward: {tuple(r.exported.shape)} "
              f"{r.exported.dtype} on {r.exported.device}, exported == "
              f"eager: {r.bit_equal}")
        return 0 if r.bit_equal else 1
    if args.rank is None:
        print(json.dumps(dryrun_multichip(args.n, args.device)))
        return 0
    import torch.distributed as dist

    _init_world(args.coord, args.n, args.rank, args.device)
    try:
        out = _meshed_step(args.n)
    finally:
        dist.destroy_process_group()
    print(_READY + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
