"""Helpers shared by the port's example twins (``examples/*_torch.py``).

* :func:`device` — the card (``cuda:0``, its context made at once) unless
  ``--device cpu``; a card that is not there is a RuntimeError, as in the
  port's entry points;
* :func:`accelerator` — the ``accelerator=`` word of a launch line for
  that device (``gpu`` on the card: the filter's backend takes no card
  index there);
* :func:`spawn` — a ``torch.distributed`` world of N local processes of
  the calling script (gloo on the CPU, NCCL on the card): every rank runs
  the same script with ``NNS_COORD``/``NNS_NUM_PROCS``/``NNS_PROC_ID``
  set, rank 0's output is the script's, and no rank outlives the call;
* :func:`write_rank` — a rank's JSON (and rank 0's arrays) into an
  output directory;
* :func:`load_data` — a ``.npz`` of inputs and parameter pytrees (object
  arrays), e.g. nnstreamer_tpu's weights for a run held against it.

The module imports ``torch`` and ``nnstreamer_tpu_torch`` only."""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def device(name: Optional[str]) -> torch.device:
    """The resolved device; on a card its context is made here, before any
    pipeline starts (a query worker's first answer would otherwise wait
    for it, past a client's timeout when other processes load the card)."""
    from nnstreamer_tpu_torch.utils.hw_accel import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    return dev


def accelerator(dev: torch.device) -> str:
    """``cpu``, or ``gpu`` (the current card; every element takes it)."""
    return "cpu" if dev.type == "cpu" else "gpu"


def in_world() -> bool:
    """True in a rank process that :func:`spawn` (or a test harness)
    started."""
    return bool(os.environ.get("NNS_NUM_PROCS"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(dev: torch.device) -> None:
    """This process's group: the spawned world's, or a world of one (gloo
    on the CPU, NCCL on the card)."""
    import torch.distributed as dist

    from nnstreamer_tpu_torch.parallel import init_multihost

    if dist.is_initialized():
        return
    if in_world():
        init_multihost()
    else:
        if dev.type == "cpu":
            # init_multihost picks NCCL wherever a card is visible
            dist.init_process_group("gloo",
                                    init_method=f"tcp://127.0.0.1:{free_port()}",
                                    world_size=1, rank=0)
        else:
            init_multihost(f"127.0.0.1:{free_port()}", 1, 0)


def close_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def spawn(script: str, argv: Sequence[str], n: int, dev: torch.device,
          timeout_s: float = 900.0) -> int:
    """Run ``script argv`` as ``n`` ranks; print rank 0's output (and every
    rank's on a failure); return the first non-zero exit code, else 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               NNS_COORD=f"127.0.0.1:{free_port()}", NNS_NUM_PROCS=str(n))
    if dev.type == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif torch.cuda.device_count() < n:
        raise RuntimeError(
            f"--world {n} needs {n} cards (one process per card); this "
            f"machine has {torch.cuda.device_count()}")
    procs = []
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, script, *argv],
                env=dict(env, NNS_PROC_ID=str(rank)), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:   # a rank stuck in a collective must not outlive us
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    rcs = [p.returncode for p in procs]
    print(logs[0], end="")
    bad = [rc for rc in rcs if rc != 0]
    if bad:
        for rank, log in enumerate(logs[1:], 1):
            print(f"--- rank {rank} (exit {rcs[rank]}) ---\n{log}", end="")
        return bad[0]
    return 0


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def write_rank(out_dir: Optional[str], out: dict, arrays: dict) -> None:
    """``out_dir/out<rank>.json``, and rank 0's ``out_dir/arrays.npz``."""
    if not out_dir:
        return
    r = rank()
    with open(os.path.join(out_dir, f"out{r}.json"), "w") as fh:
        json.dump(out, fh)
    if arrays and r == 0:
        np.savez(os.path.join(out_dir, "arrays.npz"), **arrays)


def load_data(path: Optional[str]) -> dict:
    """A ``.npz`` as a dict; object arrays (parameter pytrees) unwrapped."""
    if not path:
        return {}
    data = dict(np.load(path, allow_pickle=True))
    return {k: (v.item() if v.dtype == object and v.shape == () else v)
            for k, v in data.items()}
