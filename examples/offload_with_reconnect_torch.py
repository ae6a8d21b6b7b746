"""Among-device offload with failure recovery, on the port: the
counterpart of ``examples/offload_with_reconnect.py``.

A client pipeline round-trips every frame to a worker pipeline over the
tensor-query protocol; the worker's ``tensor_filter framework=torch
model=builtin://scaler`` runs on the card. The worker is killed and
restarted mid-stream (x2, then x5, on the same port) and the client
reconnects with backoff: frames pushed during the outage are dropped, the
stream never dies.

    python examples/offload_with_reconnect_torch.py          # cuda:0
    python examples/offload_with_reconnect_torch.py --device cpu

The timings are the reference's (a 0.5 s outage, a 20 s reconnect window,
0.5 s backoff cap, a frame every 30 ms). The last line is a JSON summary:
the answers before and after the restart, frames pushed, answered and
unanswered (before the kill, and after it).
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

CAPS = "other/tensors,format=static,dimensions=4,types=float32"
FIRST_WAIT_S = 60.0


def start_worker(port: int, server_id: int, factor: float, acc: str):
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(
        f"tensor_query_serversrc name=src id={server_id} port={port} "
        f"caps={CAPS} "
        f"! tensor_filter framework=torch accelerator={acc} "
        f"model=builtin://scaler?factor={factor} "
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

    worker, port = start_worker(0, server_id=100, factor=2.0, acc=acc)
    client = parse_launch(
        f"appsrc name=in caps={CAPS} "
        f"! tensor_query_client host=127.0.0.1 port={port} "
        "reconnect-window=20 max-reconnect-delay=0.5 "
        "! tensor_sink name=out")
    out = []
    client.get("out").connect(
        lambda b: out.append(float(np.asarray(b.as_numpy().tensors[0])[0])))
    client.play()
    src = client.get("in")
    pushed = 0
    try:
        # the reference waits 20 s for the first answers; on a loaded card
        # host a worker's first answer can take longer
        deadline = time.monotonic() + FIRST_WAIT_S
        while len(out) < 5 and time.monotonic() < deadline:
            src.push_buffer(np.ones(4, np.float32))
            pushed += 1
            time.sleep(0.03)
        if len(out) < 5:
            raise SystemExit("worker never answered — check the logs above")
        before = out[-3:]
        print(f"worker x2 on {acc} answered {len(out)} frames: {before}")

        pushed_first, answered_first = pushed, len(out)
        print("killing worker ...")
        worker.stop()
        time.sleep(0.5)
        worker, _ = start_worker(port, server_id=101, factor=5.0, acc=acc)
        print("worker restarted (now x5); streaming continues:")

        n = len(out)
        deadline = time.monotonic() + 20
        while len(out) < n + 5 and time.monotonic() < deadline:
            src.push_buffer(np.ones(4, np.float32))
            pushed += 1
            time.sleep(0.03)
        after = out[-3:]
        resumed = sum(1 for v in out[n:] if v == 5.0)
        print(f"answers after restart: {after} (values switched 2.0 → 5.0)")
    finally:
        client.stop()
        worker.stop()
    dropped_connecting = pushed_first - answered_first
    dropped_outage = (pushed - pushed_first) - (len(out) - answered_first)
    summary = {"before": before, "after": after, "pushed": pushed,
               "answered": len(out), "dropped": pushed - len(out),
               "dropped_connecting": dropped_connecting,
               "dropped_outage": dropped_outage, "resumed": resumed,
               "accelerator": acc}
    print(f"frames: {pushed} pushed, {len(out)} answered; unanswered "
          f"{dropped_connecting} before the kill (pushed while the client "
          f"first connected, or in flight) and {dropped_outage} after it "
          f"(while the client reconnected); {resumed} answered by the "
          "restarted worker")
    print(json.dumps(summary))
    return 0 if after == [5.0] * 3 and before == [2.0] * 3 else 1


if __name__ == "__main__":
    sys.exit(main())
