"""What the systems share: the sampled buffers stacked, and the check
of the numbers a system compares against the limits its configuration
states."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def stack(sample: Dict[int, torch.Tensor], labels: Dict[int, List[int]],
          frames: Dict[int, torch.Tensor], per: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(outputs, labels, frames) of the sampled buffers in order; a label
    that never came reads -1."""
    seqs = sorted(sample)
    out = torch.cat([sample[s] for s in seqs])
    lab = torch.tensor([(labels.get(s, []) + [-1] * per)[:per][i]
                        for s in seqs for i in range(per)])
    return out, lab, torch.cat([frames[s] for s in seqs])


def labels_of(out: torch.Tensor, per: int) -> torch.Tensor:
    """The argmax of each frame's outputs, buffer by buffer, as the
    decoder takes it on the card."""
    return torch.cat([torch.argmax(out[i:i + per].reshape(per, -1), -1)
                      for i in range(0, out.shape[0], per)])


def tail(labels, per: int, queues: bool) -> str:
    """The line after the filter: a ``tee``, one branch to the decoder and
    the labels' sink, one to the sink of the filter's outputs. With
    ``queues`` each branch runs on a thread of its own (the filter's
    thread goes on to the next buffer while the decoder pulls); without,
    both run on the filter's thread, one after the other."""
    q = "queue max-size-buffers=0 ! " if queues else ""
    return (f"tee name=t t. ! {q}tensor_decoder mode=image_labeling "
            f"option1={labels} frames-in={per} name=dec ! tensor_sink name=out "
            f"max-stored=1 t. ! {q}tensor_sink name=raw max-stored=1")


def frame_mismatch(out: torch.Tensor, ref: torch.Tensor,
                   frames: torch.Tensor) -> float:
    """Frames whose outputs lie nearer (Euclidean) the reference's outputs
    of another sampled frame than their own: answers given to the wrong
    frame. Frames with the same input are not each other's others."""
    out, ref = out.to(ref.device, torch.float64), ref.to(torch.float64)
    d = torch.cdist(out, ref)
    own = d.diagonal().clone()
    flat = frames.reshape(frames.shape[0], -1).to(ref.device, torch.int64)
    gen = torch.Generator().manual_seed(0)
    weights = torch.randint(1, 1 << 20, (flat.shape[1],), generator=gen)
    key = (flat * weights.to(ref.device)).sum(-1)      # exact: equal frames, equal keys
    d[key[:, None] == key[None, :]] = float("inf")
    return float((d.min(1).values < own).sum())


def numbers(system, out: torch.Tensor, labels: torch.Tensor, ref: torch.Tensor,
            frames: torch.Tensor) -> Dict[str, float]:
    """Every number ``system`` can compare, of ``out`` and ``labels``."""
    vals = system.numbers(out, labels, ref)
    vals["frame_mismatch"] = frame_mismatch(out, ref, frames)
    return vals


def check(system, sample, labels, frames) -> Dict[str, Dict[str, float]]:
    """Each number the configuration limits, beside its limit."""
    limits = system.cfg["limits"]
    if not sample:
        return {k: {"value": float("inf"), "limit": v} for k, v in limits.items()}
    out, lab, x = stack(sample, labels, frames, system.mix["frames_per_buffer"])
    vals = numbers(system, out, lab, system.reference(x), x)
    return {k: {"value": vals[k], "limit": limits[k]} for k in limits}
