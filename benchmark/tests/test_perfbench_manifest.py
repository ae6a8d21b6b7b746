"""BENCHMARK.json against the contract's limits on names, units and
files, and the harness finding every file it names."""
import json
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
MANIFEST = core.load_manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(_one_line(w) for w in MANIFEST["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names), names


def test_metrics():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(x for x in MANIFEST["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", cells), (m["name"], w)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_enough():
    for w in MANIFEST["workloads"]:
        cell = core.find_cell(MANIFEST, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _one_line(w["why"])


def test_configs_and_files():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert c["name"] in used and _one_line(c["source"]) and _one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_every_metric_has_a_reader():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(core.load_reader(m["name"]))


def test_a_full_check_fits_its_time():
    cells, secs = 24, MANIFEST["run_seconds"]
    assert (2 + 14 * cells) * (secs + 60) + cells * 2 * 90 + 1200 <= 43200
