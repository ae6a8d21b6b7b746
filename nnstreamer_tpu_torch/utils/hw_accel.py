"""Device choice for the port's entry points.

Every entry point runs on the card (``cuda:0``) unless the caller asks
for the CPU; pipeline elements name the device with one ``accelerator``
grammar (:func:`device_for_accelerator`). There is no quiet fallback:
asking for the card on a machine without one is an error that says how
to ask for the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda:0``; ``"cpu"`` / ``"cuda:N"`` / a torch.device as
    given. Raises RuntimeError for a CUDA device that is not present."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device available for {dev}; pass device='cpu' "
                "(accelerator=cpu on a pipeline element) to run on the CPU")
        n = torch.cuda.device_count()
        if dev.index >= n:
            raise RuntimeError(
                f"CUDA device {dev.index} out of range ({n} devices)")
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev} (expected cpu or cuda)")
    return dev


def device_for_accelerator(accelerator: str) -> torch.device:
    """A pipeline element's ``accelerator`` word → its device: ``auto``,
    ``gpu`` and ``cuda`` → ``cuda:0``; ``cuda:N``; ``cpu``. Raises
    ValueError for any other word (and RuntimeError, from
    :func:`resolve_device`, for a card that is not present)."""
    acc = accelerator.strip().lower()
    if acc in ("", "auto", "gpu", "cuda"):
        return resolve_device(None)
    if acc == "cpu" or (acc.startswith("cuda:") and acc[5:].isdigit()):
        return resolve_device(acc)
    raise ValueError(f"accelerator {accelerator!r} is not one of auto, "
                     "gpu, cuda, cuda:N, cpu")
