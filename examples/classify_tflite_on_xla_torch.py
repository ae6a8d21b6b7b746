"""Run a real ``.tflite`` model on the card through a full pipeline: the
counterpart of ``examples/classify_tflite_on_xla.py``.

The reference compiles the file to an XLA program; the port reads the
flatbuffer itself (``models/tflite_schema.py``) and runs the graph in
PyTorch on the card (``models/tflite_import.py``), with the same caps, the
same uint8 output and the same labels. Its default executor for a
quantized graph is fake-quant, the reference's default too: dequantized
float math in XLA's FMA orders, whose convolutions, fully-connected layer
and mean run through the hand-written ``fma_gemm`` and ``depthwise_fma``
kernels on the card. The script names the mode and prints both kernels'
launches.

    python examples/classify_tflite_on_xla_torch.py [model.tflite]
    python examples/classify_tflite_on_xla_torch.py --device cpu

The default model is the repo's committed full-width int8 MobileNet-v2
fixture (``tests/fixtures/mobilenet_v2_1.0_224_int8.tflite``); the
reference's default, a file of its upstream checkout, is not carried.
``--batch``/``--buffers`` (default 1 and 4, the reference's) size the
stream, of the model's input type. The last line is a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_world as W  # noqa: E402

DEFAULT = os.path.join(W.ROOT, "tests", "fixtures",
                       "mobilenet_v2_1.0_224_int8.tflite")
# the port's default executor of a quantized graph, named in the output
MODE = "fake-quant"
# tflite TensorType codes of the stream types tensor_src makes
TFLITE_TYPES = {0: "float32", 3: "uint8", 9: "int8"}


def input_type(path: str) -> str:
    """The model's first input's type as a caps word (the reference's
    default model takes uint8, the committed fixture int8)."""
    from nnstreamer_tpu_torch.models.tflite_schema import Model

    with open(path, "rb") as fh:
        g = Model(fh.read()).subgraphs[0]
    return TFLITE_TYPES[g.tensors[g.inputs[0]].type]


def main(argv=None) -> int:
    from nnstreamer_tpu_torch.ops.depthwise_fma import depthwise_fma
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default=DEFAULT)
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--buffers", type=int, default=4)
    args = ap.parse_args(argv)
    acc = W.accelerator(W.device(args.device))
    if not os.path.exists(args.model):
        raise SystemExit(f"model not found: {args.model}\nusage: python "
                         "examples/classify_tflite_on_xla_torch.py "
                         "[model.tflite]")
    custom = f"quantized_exec:{MODE}"
    if args.batch > 1:
        custom += f",batch:{args.batch}"
    pipe = parse_launch(
        f"tensor_src num-buffers={args.buffers} "
        f"dimensions=3:224:224:{args.batch} types={input_type(args.model)} "
        "pattern=random "
        f"! tensor_filter framework=torch accelerator={acc} "
        f"model={args.model} custom={custom} "
        f"! tensor_decoder mode=image_labeling frames-in={args.batch} "
        "! tensor_sink name=out")
    labels = []
    pipe.get("out").connect(lambda b: labels.append(b.meta.get("label")))
    fma_gemm.launches = 0
    depthwise_fma.launches = 0
    pipe.run(timeout=600)
    launches = {"fma_gemm": fma_gemm.launches,
                "depthwise_fma": depthwise_fma.launches}
    print(f"{os.path.basename(args.model)} ({MODE}) on {acc} → top-1 "
          f"class ids: {labels[:16]}")
    print("launches: " + json.dumps(launches))
    print(json.dumps({"labels": labels, "mode": MODE,
                      "batch": args.batch, "buffers": args.buffers,
                      "launches": launches, "accelerator": acc}))
    return 0 if len(labels) == args.batch * args.buffers else 1


if __name__ == "__main__":
    sys.exit(main())
