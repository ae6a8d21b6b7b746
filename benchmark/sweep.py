"""The sustainable rate of an open-loop cell, found by a sweep on the card.

    python3 benchmark/sweep.py --workload <cell> --seconds <s> --seed <n> --rates <frames/s> ...
        [--set <mix key>=<JSON value> ...]

Runs the cell once at each offered rate (the traffic file's rate
replaced, and any mix parameter ``--set`` names) and prints, per rate, the share of the window's
buffers labelled within the window and a second after it, the median and
95th-percentile latency, and how the median latency of the window's last
fifth compares with its first fifth (a backlog that grows shows as a
ratio well above 1). The knee is the highest rate with at least 99% of
buffers labelled and no growing backlog; a cell is run at a fixed share
of it, written into its traffic file as a number.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON")
    args = p.parse_args(argv)
    changes = {k: json.loads(v) for k, v in (a.split("=", 1) for a in args.set)}
    core.configure_caches()
    for rate in args.rates:
        cell = core.find_cell(core.load_manifest(), args.workload)
        cell.traffic.update(changes, rate_frames_per_s=rate)
        t = time.perf_counter()
        res = core.run_cell(cell, args.seed, args.seconds, False, t, "cuda:0")
        rec = res["record"]
        end = rec.t0 + rec.seconds + 1.0
        lat = [rec.completed.get(s, float("inf")) - d for s, d in enumerate(rec.due)]
        n = len(lat)
        on_time = sum(1 for s in range(n) if rec.completed.get(s, end + 1) <= end) / n
        fifth = max(n // 5, 1)
        first = statistics.median(lat[:fifth])
        last = statistics.median(lat[-fifth:])
        print(json.dumps({
            "rate": rate, "set": changes, "buffers": n, "labelled_share": on_time,
            "p50_ms": core.load_reader("latency_p50_ms")(rec),
            "p95_ms": core.load_reader("latency_tail_p95_ms")(rec),
            "backlog_ratio": last / first if first > 0 else None,
            "correct": res["correct"], "failed": res["failed"],
            "checks": {k: c["value"] for k, c in res["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
