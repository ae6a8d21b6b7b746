"""The benchmark's command: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for. Prints one JSON line last on standard output (see
``benchmark/core.py``); exits non-zero, printing no result, without a
card, outside a checkout that holds the program, or when the process
holds JAX or the JAX package after the window.
"""
import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
