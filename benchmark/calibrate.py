"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell (a short window at the cell's own
load and sizes) gives the numbers its check compares: these are the
program's readings, the lower ones. On the same sampled frames and
weights, the control (the configuration's plain reference computed one
precision step below the one it states) is then put in the program's
place, its labels being its own argmax: these are the upper readings.
Prints one JSON line per seed and a summary line: the largest program
reading and the smallest control reading of each number. The benchmark's
own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

STARTED = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402
from benchmark.systems import common  # noqa: E402


def readings(system, res: dict, control: bool) -> dict:
    """Every number the system can compare, of the program's sampled
    outputs and, with ``control``, of the control's on the same frames."""
    per = system.mix["frames_per_buffer"]
    out, lab, x = common.stack(res["sample"], res["labels"], res["frames"], per)
    ref = system.reference(x)
    got = {"program": common.numbers(system, out, lab, ref, x)}
    if control:
        ctl = system.control(x)
        got["control"] = common.numbers(system, ctl, common.labels_of(ctl, per), ref, x)
    return got


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    core.configure_caches()
    cell = core.find_cell(core.load_manifest(), args.workload)
    lows, highs = {}, {}
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        res = core.run_cell(cell, seed, args.seconds, False, t, args.device,
                            keep_frames=True)
        line = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"]}
        line.update(readings(res["record"].system, res, i < args.control_seeds))
        for k, v in line.get("control", {}).items():
            highs[k] = min(highs.get(k, float("inf")), v)
        for k, v in line["program"].items():
            lows[k] = max(lows.get(k, float("-inf")), v)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    print(json.dumps({"cell": cell.name, "program_max": lows, "control_min": highs,
                      "seeds": args.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
