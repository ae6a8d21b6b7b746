"""Multi-process runtime bring-up for the parallel layer.

The port of nnstreamer_tpu's ``parallel/multihost.py``. The reference wires
the JAX distributed runtime; here every process is one rank of a
``torch.distributed`` world (one card each): ``init_multihost()`` reads the
reference's environment names — ``NNS_COORD`` ("host:port" of rank 0),
``NNS_NUM_PROCS``, ``NNS_PROC_ID`` — and calls ``init_process_group`` on
``tcp://NNS_COORD``. A coordinator that is already an init-method URL
(``file:///path/store``, ``tcp://host:port``) is passed as it is: a file
store needs no port, so worlds started side by side on one host cannot
race for one. The backend is NCCL where a card is present (the
rank's card is ``cuda:<rank % cards>``) and gloo on a machine without one;
a failed NCCL bring-up is an error, never a gloo run. Nothing in a machine
tells a process of a cluster, so with none of the three set the call is a
single-process no-op (False).

``global_mesh()`` builds the dp/tp/sp mesh over every rank (a one-rank
world is brought up first where none is), ``process_info()`` reports the
rank and counts.
"""
from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Sequence

import torch

from ..utils.log import logger
from .mesh import AXES, factor_devices, make_mesh


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Bring up the process group (idempotent): NCCL with a card, gloo
    without. Arguments default from ``NNS_COORD``, ``NNS_NUM_PROCS`` and
    ``NNS_PROC_ID``. Returns True when a process group is up (this call's
    or an earlier one), False for the single-process no-op."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("NNS_COORD")
    num_processes = num_processes or _env_int("NNS_NUM_PROCS")
    process_id = (process_id if process_id is not None
                  else _env_int("NNS_PROC_ID"))
    if coordinator is None and num_processes is None and process_id is None:
        return False
    missing = [name for name, val in (
        ("NNS_COORD", coordinator), ("NNS_NUM_PROCS", num_processes),
        ("NNS_PROC_ID", process_id)) if val is None]
    if missing:
        raise ValueError(
            f"multihost: partial distributed config — set {missing} too "
            "(or none of them for a single-process run)")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    logger.info("multihost: initialized process %d of %d via %s (%s)",
                process_id, num_processes, coordinator, backend)
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def global_mesh(axis_sizes: Optional[Dict[str, int]] = None,
                axes: Sequence[str] = AXES):
    """A dp/tp/sp mesh over every rank of the world. With no process
    group up, a one-rank world on this host is brought up first, so the
    same entry script runs alone. Warns when tp × sp exceeds the ranks of
    one host (their collectives would cross hosts; prefer dp there)."""
    import torch.distributed as dist

    if not init_multihost():
        init_multihost(f"127.0.0.1:{_free_port()}", 1, 0)
    n = dist.get_world_size()
    sizes = axis_sizes or factor_devices(n, axes)
    local = _local_ranks()
    tp_sp = sizes.get("tp", 1) * sizes.get("sp", 1)
    if tp_sp > local and n > local:
        logger.warning(
            "global_mesh: tp*sp=%d exceeds the %d ranks of a host — model/"
            "sequence collectives will cross hosts; prefer dp for the "
            "cross-host axis", tp_sp, local)
    return make_mesh(None, sizes)


def _local_ranks() -> int:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.cuda.device_count()
    return dist.get_world_size()   # gloo worlds of this package run on one host


def process_info() -> Dict[str, int]:
    """Rank, world size, and local/global device counts (one card per
    rank: ``local_devices`` is 1 and ``global_devices`` the world size)."""
    import torch.distributed as dist

    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": world,
            "local_devices": 1,
            "global_devices": world}
