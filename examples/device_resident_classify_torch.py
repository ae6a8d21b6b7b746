"""Device-resident classification on the port: no full-width host
transfers at all. The counterpart of ``examples/device_resident_classify.py``.

Frames are generated ON the card (``tensor_src device=true``: a
``torch.Generator`` per frame, standing in for any device-resident
ingest), the u8 MobileNet-v2 (224×224×3, width 1.0, 1001 classes; bf16 on
the card, float32 on the CPU) consumes them where they live, and the
decoder reduces the whole batch on the card (``frames-in=N``: one argmax
and ONE compact pull), emitting N per-frame label buffers. The only
card→host traffic is one int32 per frame, which the script measures at
the decoder and prints.

    python examples/device_resident_classify_torch.py          # cuda:0
    BATCH=4 BUFFERS=2 python examples/device_resident_classify_torch.py \\
        --device cpu

``BATCH`` (default 8) and ``BUFFERS`` (default 3) are the reference's
knobs. Weights are the port's seeded init unless ``--params`` names a
``.npz`` whose ``params`` entry is nnstreamer_tpu's MobileNet-v2 pytree.
The frames are not the reference's (it draws them from ``jax.random``).
The last line is a JSON summary: the labels, the bytes pulled from the
card per frame, and the frames decoded on the host path (0).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_world as W  # noqa: E402

BATCH = int(os.environ.get("BATCH", "8"))
BUFFERS = int(os.environ.get("BUFFERS", "3"))
# the entry carrying --params, named by the launch line as __main__:MODEL
MODEL = None


def count_pulls(dec) -> dict:
    """Wrap the decoder element's batched reduce (whose outputs are the
    only tensors it pulls to the host) and its host decode (which would
    pull the full logits); return the counters they fill."""
    stats = {"pulled_bytes": 0, "reduced_frames": 0, "host_decodes": 0,
             "input_devices": set()}
    get_reduce = dec._get_reduce

    def counted_get_reduce():
        fn = get_reduce()
        if fn is None:
            return None

        def reduce(tensors):
            stats["input_devices"].update(str(t.device) for t in tensors)
            out = fn(tensors)
            stats["pulled_bytes"] += sum(t.numel() * t.element_size()
                                         for t in out)
            stats["reduced_frames"] += dec.props["frames_in"]
            return out
        return reduce

    host_decode = dec.decoder.decode

    def counted_decode(buf, info):
        stats["host_decodes"] += 1
        return host_decode(buf, info)

    dec._get_reduce = counted_get_reduce
    dec.decoder.decode = counted_decode
    return stats


def main(argv=None) -> int:
    global MODEL
    from nnstreamer_tpu_torch.models import mobilenet_v2
    from nnstreamer_tpu_torch.models._blocks import make_u8_entry
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    ap.add_argument("--params", help=".npz with nnstreamer_tpu's MobileNet-v2 "
                    "pytree under 'params' (default: the port's seeded init)")
    args = ap.parse_args(argv)
    acc = W.accelerator(W.device(args.device))
    data = W.load_data(args.params)
    if "params" in data:
        MODEL = make_u8_entry(replace(mobilenet_v2.filter_model,
                                      params=data["params"]))
        model = "__main__:MODEL"
    else:
        model = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8"

    with tempfile.TemporaryDirectory(prefix="nns_example_") as tmp:
        labels = os.path.join(tmp, "labels.txt")
        with open(labels, "w") as fh:
            fh.write("\n".join(f"class{i}" for i in range(1001)))
        pipe = parse_launch(
            f"tensor_src device=true accelerator={acc} pattern=random "
            f"num-buffers={BUFFERS} dimensions=3:224:224:{BATCH} types=uint8 "
            f"! tensor_filter framework=torch accelerator={acc} "
            f"model={model} sync-invoke=false "
            "! queue max-size-buffers=4 "
            f"! tensor_decoder name=d mode=image_labeling option1={labels} "
            f"frames-in={BATCH} "
            "! tensor_sink name=out max-stored=4")
        stats = count_pulls(pipe.get("d"))
        got = []
        pipe.get("out").connect(got.append)
        pipe.run(timeout=600)
    names = [b.meta["label"] for b in got]
    print(f"{len(got)} frames labeled ({BUFFERS} batches x {BATCH} on "
          f"{acc}):")
    print(" ", names[: 2 * BATCH])
    per_frame = stats["pulled_bytes"] / max(stats["reduced_frames"], 1)
    print(f"pulled from {sorted(stats['input_devices'])}: "
          f"{stats['pulled_bytes']} bytes for {stats['reduced_frames']} "
          f"frames = {per_frame:g} bytes per frame (one int32); frames "
          f"decoded on the host path: {stats['host_decodes']}")
    print(json.dumps({"labels": [int(b.meta["label_index"]) for b in got],
                      "frames": len(got),
                      "pulled_bytes_per_frame": per_frame,
                      "host_decodes": stats["host_decodes"],
                      "input_devices": sorted(stats["input_devices"]),
                      "accelerator": acc}))
    ok = (len(got) == BUFFERS * BATCH and per_frame == 4
          and stats["host_decodes"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
