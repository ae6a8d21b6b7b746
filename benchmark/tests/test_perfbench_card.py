"""Each cell run by the benchmark's own command on the card, short: the
contract's result line, correct. Runs only where a card is
(``pytest -m cuda benchmark/tests``)."""
import json
import subprocess
import sys

import pytest

from benchmark import core

CELLS = [w["name"] for w in core.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(2**31 + 17),
         "--seconds", "6", "--trace", str(trace)],
        cwd=core.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = core.find_cell(core.load_manifest(), name)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_outside_a_checkout_of_the_program_it_fails(tmp_path):
    import shutil

    shutil.copytree(core.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
