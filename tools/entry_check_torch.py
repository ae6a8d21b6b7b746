#!/usr/bin/env python
"""``nnstreamer_tpu_torch.entry.entry()`` on the card, one JSON line: the
port's counterpart of ``tools/entry_check.py``.

``entry()`` exports MobileNet-v2's float32 forward with ``torch.export``
and runs it beside the eager forward (they must be bit-equal). This tool
reports the first call's seconds (model build, export and the first run:
the counterpart of the reference's ``compile_s``), then a steady
``step_ms_p50`` over 10 calls of the exported program, each timed by
CUDA events on the card (host clock on the CPU).

    python tools/entry_check_torch.py                 # cuda:0
    python tools/entry_check_torch.py --device cpu

The line is ``{"metric": "graft_entry_forward", ...}``; the exit code is
1 if the exported program's logits are not the eager forward's.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

STEPS = 10


def main(argv=None) -> int:
    from nnstreamer_tpu_torch.entry import entry
    from nnstreamer_tpu_torch.utils.hw_accel import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda:N (default cuda:0) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.monotonic()
    res = entry(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    compile_s = time.monotonic() - t0
    fn = res.program.module()
    steps = []
    with torch.no_grad():
        for _ in range(STEPS):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(res.inputs)
                end.record()
                end.synchronize()
                steps.append(start.elapsed_time(end))
            else:
                t_s = time.perf_counter()
                fn(res.inputs)
                steps.append((time.perf_counter() - t_s) * 1e3)
    print(json.dumps({
        "metric": "graft_entry_forward",
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "compile_s": compile_s,
        "step_ms_p50": statistics.median(steps),
        "timer": "cuda events" if dev.type == "cuda" else "host clock",
        "bit_equal": res.bit_equal,
        "total_s": time.monotonic() - t0,
    }))
    return 0 if res.bit_equal else 1


if __name__ == "__main__":
    sys.exit(main())
