"""A full-integer ``.tflite`` classifier served through the program's
importer.

The line: ``appsrc`` (uint8 frame buffers already on the card) →
``tensor_transform`` (``typecast:int16,add:-128,typecast:int8``: the
uint8 frames as the model's int8 input) → ``tensor_filter
framework=torch model=<file> custom=<options>`` → ``tee`` →
``tensor_decoder mode=image_labeling`` → labels, and the filter's int8
outputs to a second sink. The file is the configuration's, checked
against the SHA-256 the configuration states. The mix's ``branch_queues``
says whether the two branches after the ``tee`` get threads of their own.

The check holds, over the sampled buffers, the filter's outputs and the
decoder's labels against ``references/tflite_int8.py``, which parses the
same file itself and executes TFLite's int8 semantics on the same uint8
frames:

- ``logit_lsb``: the largest gap between an output and the reference's,
  in steps of the output's quantisation;
- ``logit_rms_lsb``: the root mean square of those gaps;
- ``label_mismatch``: labels that are not the argmax of their frame's
  outputs (exact).
"""
from __future__ import annotations

import hashlib
from typing import Dict

import torch

from .. import flops
from . import common
from ..references.tflite_int8 import TfliteInt8Reference, int8_input

REF_BLOCK = 32


class System:
    def __init__(self, cfg: Dict, mix: Dict, seed: int, device, root):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.path = root / cfg["model_file"]
        self.num_classes = cfg["num_classes"]
        self.entry = None
        self._ref = None
        self.peak = flops.PEAKS[cfg["peak_arithmetic"]]
        self._graph = None

    @property
    def graph(self):
        if self._graph is None:
            from ..tflite_reader import read_graph

            self._graph = read_graph(self.path.read_bytes())
        return self._graph

    def launches(self, batch: int):
        return flops.tflite_launches(self.graph, batch)

    @property
    def flops_per_frame(self) -> float:
        per = self.launches(1)
        return sum(o for o, _ in per["gemm"] + per["depthwise"])

    def prepare(self, pool: torch.Tensor) -> None:
        digest = hashlib.sha256(self.path.read_bytes()).hexdigest()
        if digest != self.cfg["model_sha256"]:
            raise RuntimeError(f"{self.path}: sha256 {digest}, the configuration "
                               f"states {self.cfg['model_sha256']}")

    def launch(self, labels, per: int) -> str:
        h, w, c = self.mix["frame"]
        cpu = " accelerator=cpu" if self.device.type == "cpu" else ""
        custom = self.cfg["custom"].format(batch=per)
        return (
            f"appsrc name=src caps=other/tensors,format=static,"
            f"dimensions={c}:{w}:{h}:{per},types=uint8 max-queued=1000000 "
            f"! tensor_transform mode=arithmetic "
            f"option=typecast:int16,add:-128,typecast:int8 name=head{cpu} "
            f"! tensor_filter framework=torch model={self.path} "
            f"custom={custom} name=f{cpu} ! "
            + common.tail(labels, per, self.mix["branch_queues"]))

    def release(self) -> None:
        pass

    def reference(self, frames: torch.Tensor, bits: int = 8) -> torch.Tensor:
        ref = TfliteInt8Reference(self.path, frames.device, bits)
        return torch.cat([ref(int8_input(frames[i:i + REF_BLOCK]))
                          for i in range(0, frames.shape[0], REF_BLOCK)])

    def control(self, frames: torch.Tensor) -> torch.Tensor:
        return self.reference(frames, self.cfg["control_bits"])

    labels_of = staticmethod(common.labels_of)

    def numbers(self, out: torch.Tensor, labels: torch.Tensor,
                ref: torch.Tensor) -> Dict[str, float]:
        out = out.to(ref.device, torch.int32)
        ref = ref.to(torch.int32)
        diff = (out - ref).abs()
        picked = ref.gather(1, labels.clamp(min=0)[:, None].to(ref.device)).squeeze(1)
        gap = (ref.max(-1).values - picked).max()
        per = self.mix["frames_per_buffer"]
        mismatch = (self.labels_of(out, per).cpu() != labels.cpu()).sum()
        return {"logit_lsb": float(diff.max()),
                "logit_rms_lsb": float(diff.double().pow(2).mean().sqrt()),
                "label_gap_lsb": float(gap), "label_mismatch": float(mismatch)}

    def check(self, sample, labels, frames) -> Dict[str, Dict[str, float]]:
        return common.check(self, sample, labels, frames)
