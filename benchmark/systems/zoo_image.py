"""A zoo image model of the program served on uint8 camera frames.

The line: ``appsrc`` (uint8 frame buffers already on the card) →
``tensor_transform mode=arithmetic option=<the configuration's
transform>`` (the normalisation) → ``tensor_filter framework=torch``
with the configuration's ``entry`` in its compute dtype → ``tee`` →
``tensor_decoder mode=image_labeling`` → labels, and the filter's logits
to a second sink. The transform and the filter make a run of two device
elements, which the runtime fuses into one segment (a lone filter is not
fused). The entry is handed the
benchmark's seeded weights as ``params``. The mix's ``branch_queues``
says whether the two branches after the ``tee`` get threads of their own.

The check holds, over the sampled buffers, the filter's logits and the
decoder's labels against the plain reference of ``references/`` fed
the same uint8 frames and weights:

- ``logit_err``: the largest gap between a logit and the reference's,
  over the reference frame's standard deviation of logits;
- ``logit_rms_err``: the root mean square of those gaps;
- ``label_gap``: the largest amount by which the reference's logit of
  the decoder's label lies below the reference's best, same scale;
- ``label_mismatch``: labels that are not the argmax of their frame's
  logits (exact).
"""
from __future__ import annotations

import importlib
from dataclasses import replace
from typing import Dict

import torch

from .. import flops
from . import common

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# frames the reference takes at once
REF_BLOCK = 64


class System:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, root):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.num_classes = cfg["num_classes"]
        self.ref = importlib.import_module(f"benchmark.references.{cfg['reference']}")
        self.weights = None
        self.entry = None
        self.peak = flops.PEAKS[cfg["compute_dtype"]]
        self.flops_per_frame = 2.0 * flops.mobilenet_v2_macs(
            dict(cfg, frame=mix["frame"]))

    def prepare(self, pool: torch.Tensor) -> None:
        """The weights, from the seed and the first calibration frames of
        the pool, and the program's entry holding them."""
        module, attr = self.cfg["entry"].split(":")
        entry = getattr(importlib.import_module(module), attr)
        calib = pool.reshape(-1, *pool.shape[2:])[: self.cfg["calibration_frames"]]
        self.weights = self.ref.make_weights(self.cfg, self.seed, calib,
                                             _DTYPES[self.cfg["compute_dtype"]])
        tree = self.ref.flax_tree(self.cfg, self.weights)
        self.entry = replace(entry, params=tree, compute_dtype=self.cfg["compute_dtype"])

    def launch(self, labels, per: int) -> str:
        h, w, c = self.mix["frame"]
        cpu = " accelerator=cpu" if self.device.type == "cpu" else ""
        return (
            f"appsrc name=src caps=other/tensors,format=static,"
            f"dimensions={c}:{w}:{h}:{per},types=uint8 max-queued=1000000 "
            f"! tensor_transform mode=arithmetic option={self.cfg['transform']} "
            f"name=head{cpu} "
            f"! tensor_filter framework=torch model=perfbench_entries:entry "
            f"name=f{cpu} ! " + common.tail(labels, per, self.mix["branch_queues"]))

    def release(self) -> None:
        self.entry = None

    def reference(self, frames: torch.Tensor, precision: str = "float32") -> torch.Tensor:
        outs = [self.ref.forward(self.cfg, self.weights, frames[i:i + REF_BLOCK], precision)
                for i in range(0, frames.shape[0], REF_BLOCK)]
        return torch.cat(outs)

    def control(self, frames: torch.Tensor) -> torch.Tensor:
        return self.reference(frames, self.cfg["control_precision"])

    labels_of = staticmethod(common.labels_of)

    def numbers(self, out: torch.Tensor, labels: torch.Tensor,
                ref: torch.Tensor) -> Dict[str, float]:
        out, ref = out.float(), ref.float()
        std = ref.std(-1)
        diff = (out - ref).abs() / std[:, None]
        err = diff.amax(-1).max()
        best = ref.max(-1).values
        picked = ref.gather(1, labels.clamp(min=0)[:, None].to(ref.device)).squeeze(1)
        gap = ((best - picked) / std).max()
        per = self.mix["frames_per_buffer"]
        mismatch = (self.labels_of(out, per).cpu() != labels.cpu()).sum()
        return {"logit_err": float(err),
                "logit_rms_err": float(diff.double().pow(2).mean().sqrt()),
                "label_gap": float(gap), "label_mismatch": float(mismatch)}

    def check(self, sample, labels, frames) -> Dict[str, Dict[str, float]]:
        return common.check(self, sample, labels, frames)
