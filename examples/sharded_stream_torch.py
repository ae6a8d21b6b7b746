"""Stream sharding with ordered re-join across query workers, on the
port: the counterpart of ``examples/sharded_stream.py``.

One live stream round-robins across two worker pipelines
(``tensor_shard``), each worker scales its share by 10 in a
``tensor_filter framework=torch model=builtin://scaler`` on the card, and
``tensor_unshard`` restores global order by sequence number: the
multi-host stream-sharding topology on loopback.

    python examples/sharded_stream_torch.py                  # cuda:0
    python examples/sharded_stream_torch.py --device cpu

The last line is a JSON summary: the values in the order they arrived,
and how many frames each worker answered.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import _torch_world as W  # noqa: E402

FRAMES = 12
WAIT_S = 60.0


def start_worker(server_id: int, acc: str):
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(
        f"tensor_query_serversrc name=src id={server_id} port=0 "
        "caps=other/tensors,format=static,dimensions=1,types=float32 "
        f"! tensor_filter framework=torch accelerator={acc} name=f "
        "model=builtin://scaler?factor=10 "
        f"! tensor_query_serversink id={server_id}")
    pipe.play()
    deadline = time.monotonic() + 5
    while pipe.get("src").bound_port == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    return pipe, pipe.get("src").bound_port


def main(argv=None) -> int:
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    acc = W.accelerator(W.device(args.device))

    w0, p0 = start_worker(110, acc)
    w1, p1 = start_worker(111, acc)
    client = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,dimensions=1,types=float32 "
        "! tensor_shard name=s "
        f"s.src_0 ! tensor_query_client host=127.0.0.1 port={p0} ! u.sink_0 "
        f"s.src_1 ! tensor_query_client host=127.0.0.1 port={p1} ! u.sink_1 "
        "tensor_unshard name=u ! tensor_sink name=out")
    out = []
    client.get("out").connect(
        lambda b: out.append(float(np.asarray(b.as_numpy().tensors[0])[0])))
    client.play()
    try:
        src = client.get("in")
        for i in range(FRAMES):
            src.push_buffer(np.full(1, float(i), np.float32))
            time.sleep(0.01)
        # the reference waits 10 s; a worker's first frame on the card
        # also opens its CUDA context, so the wait here is longer
        deadline = time.monotonic() + WAIT_S
        while len(out) < FRAMES and time.monotonic() < deadline:
            time.sleep(0.02)
        served = [w.get("f").stats.total_invokes for w in (w0, w1)]
    finally:
        client.stop()
        w0.stop()
        w1.stop()
    print(f"in order, each x10 by alternating workers on {acc}: {out}")
    ok = out == [float(i * 10) for i in range(FRAMES)]
    print(json.dumps({"values": out, "in_order": ok,
                      "per_worker_invokes": served, "accelerator": acc}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
