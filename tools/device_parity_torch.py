#!/usr/bin/env python
"""On-device label parity for the port: MobileNet-v2 on the card against
the same weights on the CPU, one JSON line. The port's counterpart of
``tools/device_parity.py``.

The reference runs its jitted MobileNet-v2 on the accelerator at
``highest`` matmul precision and holds its labels against TF's tflite
interpreter on the CPU, through a jax2tf export. That export is left out
of the port on purpose (ROADMAP §A: it needs jax2tf), and the card's
machine has no TensorFlow, so the port's oracle is its own CPU run: the
float32 model (seeded weights, drawn on the CPU, so both copies are the
same) through ``appsrc ! tensor_filter framework=torch ! tensor_decoder
mode=image_labeling ! tensor_sink`` on ``--device`` with TF32 off (the
counterpart of the ``highest`` pin), against the same line on the CPU.

It also runs the committed int8 MobileNet-v2 ``.tflite`` fixture in the
port's default fake-quant executor (its convolutions through the
``fma_gemm``/``depthwise_fma`` kernels on the card) on int8 frames, card
labels against the CPU's.

    python tools/device_parity_torch.py                  # cuda:0
    python tools/device_parity_torch.py --device cpu     # both sides CPU
    PARITY_FRAMES=64 ... (or --frames: the float model's frames; the
                         fixture runs one int8 frame for every 32)

Frames: ``np.random.default_rng(20260730)``, the reference's (each
(1, 224, 224, 3) in [-1, 1)), then the int8 frames from the same
generator. The line's keys follow the reference's (``metric``,
``frames``, ``mismatches``, ``parity``); the exit code is 1 on any
mismatch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "mobilenet_v2_1.0_224_int8.tflite")
# the float32 model the line serves, named as __main__:F32
F32 = None
_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(f"[parity +{time.monotonic() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def labels_through(model: str, frames, acc: str, caps_type: str,
                   custom: str = "") -> list:
    """One label per frame through ``appsrc ! tensor_filter ! tensor_decoder
    mode=image_labeling ! tensor_sink`` on ``acc``."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    extra = f" custom={custom}" if custom else ""
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions=3:224:224:1,types={caps_type} "
        f"! tensor_filter framework=torch accelerator={acc} "
        f"model={model}{extra} "
        "! tensor_decoder mode=image_labeling ! tensor_sink name=out")
    labels = []
    pipe.get("out").connect(lambda b: labels.append(b.meta["label_index"]))
    pipe.play()
    try:
        src = pipe.get("in")
        for f in frames:
            src.push_buffer(f)
        src.end_of_stream()
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    if msg is None or msg.type is not MessageType.EOS:
        raise RuntimeError(f"parity line on {acc}: {msg}")
    return [int(x) for x in labels]


def compare(a: list, b: list, n: int) -> dict:
    mismatches = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    out = {"frames": n, "card_frames": len(a), "cpu_frames": len(b),
           "mismatches": len(mismatches),
           "parity": ("exact" if not mismatches and len(a) == len(b) == n
                      else "MISMATCH")}
    if mismatches:
        out["first_mismatch_frames"] = mismatches[:5]
    return out


def main(argv=None) -> int:
    global F32
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.utils.hw_accel import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--frames", type=int,
                    default=int(os.environ.get("PARITY_FRAMES", "64")))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    acc = "cpu" if dev.type == "cpu" else "gpu"
    # full float32 products on the card: the counterpart of the
    # reference's "highest" precision pin
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F32 = replace(mobilenet_v2.filter_model, compute_dtype="float32")

    rng = np.random.default_rng(20260730)
    frames = [(rng.random((1, 224, 224, 3)) * 2 - 1).astype(np.float32)
              for _ in range(args.frames)]
    n_int8 = max(1, args.frames // 32)
    int8 = [rng.integers(-128, 128, (1, 224, 224, 3)).astype(np.int8)
            for _ in range(n_int8)]

    _log(f"float32 MobileNet-v2 on {acc} ({args.frames} frames)")
    card = labels_through("__main__:F32", frames, acc, "float32")
    _log("float32 MobileNet-v2 on cpu")
    cpu = labels_through("__main__:F32", frames, "cpu", "float32")
    result = {"metric": "label_parity_torch_card_vs_cpu",
              "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              **compare(card, cpu, args.frames)}
    _log(f"int8 fixture (fake-quant) on {acc} ({n_int8} frames)")
    q_card = labels_through(FIXTURE, int8, acc, "int8",
                            "quantized_exec:fake-quant")
    _log("int8 fixture (fake-quant) on cpu")
    q_cpu = labels_through(FIXTURE, int8, "cpu", "int8",
                           "quantized_exec:fake-quant")
    result["int8"] = compare(q_card, q_cpu, n_int8)
    ok = result["parity"] == "exact" and result["int8"]["parity"] == "exact"
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
