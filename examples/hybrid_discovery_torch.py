"""MQTT-hybrid offload on the port: broker discovery, direct-TCP data,
elastic moves. The counterpart of ``examples/hybrid_discovery.py``.

The reference's ``connect-type=HYBRID`` (nnstreamer-edge MQTT-hybrid): an
MQTT broker (the port's in-process ``MiniBroker``) carries only a
retained ``topic → host:port`` advertisement; tensor data flows over a
direct TCP link to a worker whose ``tensor_filter framework=torch
model=builtin://scaler`` runs on the card. The client re-discovers on
every reconnect, so a worker that comes back on a DIFFERENT port is found
automatically: the demo kills the worker, restarts it on a fresh
ephemeral port, and the stream resumes.

    python examples/hybrid_discovery_torch.py                # cuda:0
    python examples/hybrid_discovery_torch.py --device cpu

The timings are the reference's (a 20 s reconnect window, a frame every
0.3 s after the move); the first frame is pushed again every 0.3 s until
it is answered (the reference pushes it once). The last line is a JSON
summary: the answers before and after the move, both ports, frames
pushed, answered and dropped.
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
# the moved worker's answer to the frames pushed after the move
MOVED = 70.0
# the reference waits 15 s for the first answer; on a loaded card host a
# worker's first answer can take longer
FIRST_WAIT_S = 60.0


def start_worker(broker, server_id: int, factor: float, acc: str):
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    pipe = parse_launch(
        f"tensor_query_serversrc name=src id={server_id} port=0 "
        f"connect-type=HYBRID dest-host={broker.host} dest-port={broker.port} "
        f"topic=demo caps={CAPS} "
        f"! tensor_filter framework=torch accelerator={acc} "
        f"model=builtin://scaler?factor={factor} "
        f"! tensor_query_serversink id={server_id}")
    pipe.play()
    deadline = time.monotonic() + 10
    while pipe.get("src").bound_port == 0:
        if time.monotonic() > deadline:
            raise RuntimeError("worker never bound a port (see bus errors)")
        time.sleep(0.01)
    print(f"worker up on port {pipe.get('src').bound_port} "
          f"(advertised on the broker under 'demo')")
    return pipe


def main(argv=None) -> int:
    from nnstreamer_tpu_torch.query.mqtt import MiniBroker
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    acc = W.accelerator(W.device(args.device))

    broker = MiniBroker()
    print(f"MQTT broker (control plane only) on {broker.host}:{broker.port}")
    worker = start_worker(broker, server_id=1, factor=10.0, acc=acc)
    ports = [worker.get("src").bound_port]
    client = parse_launch(
        f"appsrc name=in caps={CAPS} "
        f"! tensor_query_client connect-type=HYBRID host={broker.host} "
        f"port={broker.port} topic=demo reconnect-window=20 "
        "! tensor_sink name=out max-stored=0")
    got = []
    client.get("out").connect(
        lambda b: got.append(float(np.asarray(b.as_numpy().tensors[0])[0])))
    client.play()
    src = client.get("in")
    pushed = 0
    try:
        # the reference pushes one frame and waits; a frame sent while the
        # client is still connecting is dropped, so this one is pushed
        # again every 0.3 s, as the frames after the move are
        deadline = time.monotonic() + FIRST_WAIT_S
        while len(got) < 1:
            if time.monotonic() > deadline:
                raise RuntimeError("no answer from the discovered worker")
            src.push_buffer(np.full(4, 1.0, np.float32))
            pushed += 1
            time.sleep(0.3)
        before = got[0]
        print(f"answer via discovered worker on {acc}: {before}")

        print("killing the worker; restarting it on a NEW ephemeral port ...")
        worker.stop()
        worker = start_worker(broker, server_id=2, factor=10.0, acc=acc)
        ports.append(worker.get("src").bound_port)

        n = len(got)
        deadline = time.monotonic() + 20
        # answers of the moved worker (x10 of 7.0); a late answer to a
        # first-frame push can still arrive in between
        while MOVED not in got[n:] and time.monotonic() < deadline:
            src.push_buffer(np.full(4, 7.0, np.float32))
            pushed += 1
            time.sleep(0.3)
        if MOVED not in got[n:]:
            raise RuntimeError("client never re-discovered the moved worker")
        after = MOVED
        print(f"answer after the move: {after} "
              "(client re-ran discovery on reconnect)")
    finally:
        client.stop()
        worker.stop()
        broker.stop()
    summary = {"before": before, "after": after, "ports": ports,
               "pushed": pushed, "answered": len(got),
               "dropped": pushed - len(got),
               "resumed": got[n:].count(MOVED),
               "accelerator": acc}
    print(f"frames: {pushed} pushed, {len(got)} answered, "
          f"{pushed - len(got)} dropped while the worker moved "
          f"(port {ports[0]} → {ports[1]})")
    print(json.dumps(summary))
    print("OK")
    return 0 if ports[0] != ports[1] else 1


if __name__ == "__main__":
    sys.exit(main())
