"""The port's tool twins (``tools/*_torch.py``) on the CPU.

* ``compat_coverage_torch.py`` and the reference's ``compat_coverage.py``
  go over one synthetic corpus: a ``runTest.sh`` of SSAT ``gstTest "..."``
  lines per suite, one suite per line of
  ``tests/test_reference_launch_compat.py``'s ``REFERENCE_LINES`` and
  ``NEGATIVE_LINES`` (the latter expect-fail). Each line's class must be
  the same in both tools. The reference's tool runs unchanged from a copy
  under the test's tmp dir, so the ``COMPAT_COVERAGE.json`` it writes
  lands there. The port now raises at construction for every negative
  line, as the reference does (``test_negative_line_raises_as_in_the_reference``;
  ROADMAP §C, D1);
* ``gen_element_docs_torch.py --check`` passes on the committed
  ``docs/elements_torch.md``, and fails on a stale copy;
* ``entry_check_torch.py`` and ``device_parity_torch.py`` pass their CPU
  forms;
* ``microbench_overhead_torch.py --smoke --device cpu`` runs every leg and
  emits every key; its stage sweep and its trace of the fused dispatch
  run on the CPU. Its timing gates are asserted on the card only
  (``chip_smoke.py`` phase 25), never here, where wall-clock ratios under
  6 xdist workers mean nothing: a run that reaches its verdicts passes
  whatever they are."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from test_reference_launch_compat import NEGATIVE_LINES, REFERENCE_LINES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")


def run_tool(name, *args, cwd=None, env=None, timeout=300):
    r = subprocess.run([sys.executable, os.path.join(TOOLS, name), *args],
                       cwd=cwd or ROOT, capture_output=True, text=True,
                       timeout=timeout, env=dict(os.environ, **(env or {})))
    return r


def last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A reference-shaped tree: tests/<suite>/runTest.sh, one gstTest line
    each (expect-fail flag 1 on the negative lines)."""
    root = tmp_path_factory.mktemp("nnstreamer")
    suites = {}
    for kind, lines, fail in (("pos", REFERENCE_LINES, 0),
                              ("neg", NEGATIVE_LINES, 1)):
        for i, line in enumerate(lines):
            suite = f"{kind}_{i:02d}"
            d = root / "tests" / suite
            d.mkdir(parents=True)
            (d / "runTest.sh").write_text(
                f'gstTest "--gst-plugin-path=${{PATH_TO_PLUGIN}} {line}" '
                f"{i} 0 {fail}\n")
            suites[suite] = line
    return root, suites


@pytest.fixture(scope="module")
def both_coverages(corpus, tmp_path_factory):
    root, _ = corpus
    work = tmp_path_factory.mktemp("ref_tool")
    (work / "tools").mkdir()
    shutil.copy(os.path.join(TOOLS, "compat_coverage.py"), work / "tools")
    ref = subprocess.run(
        [sys.executable, str(work / "tools" / "compat_coverage.py"),
         str(root)], cwd=str(work), capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert ref.returncode == 0, ref.stderr[-3000:]
    port_out = work / "port.json"
    port = run_tool("compat_coverage_torch.py", str(root), "--out",
                    str(port_out))
    assert port.returncode == 0, port.stderr[-3000:]
    return (json.loads((work / "COMPAT_COVERAGE.json").read_text()),
            json.loads(port_out.read_text()), last_json(port.stdout))


def test_compat_coverage_classifies_the_corpus_as_the_reference(
        both_coverages, corpus):
    ref, port, summary = both_coverages
    _, suites = corpus
    assert set(ref["by_suite"]) == set(port["by_suite"]) == set(suites)
    for suite in suites:
        assert port["by_suite"][suite] == ref["by_suite"][suite], \
            (suite, suites[suite])
    # each line's own record agrees with its suite's single class
    assert len(port["lines"]) == len(suites)
    for rec in port["lines"]:
        assert port["by_suite"][rec["suite"]] == {rec["class"]: 1}
    for key in ("total_lines", "constructed", "fixture_missing",
                "parse_failed", "negative_raised", "negative_constructed",
                "shell_var_skipped", "grammar_rate_evaluable"):
        assert summary[key] == ref[key] == port[key], key
    assert ref["top_failures"] == port["top_failures"]
    assert port["negative_constructed"] == 0


def test_compat_coverage_needs_a_reference_root(tmp_path):
    r = run_tool("compat_coverage_torch.py", str(tmp_path))
    assert r.returncode != 0 and "no tests/ directory" in r.stderr
    assert not os.path.exists(os.path.join(ROOT, "COMPAT_COVERAGE_torch.json"))


@pytest.mark.parametrize("line", NEGATIVE_LINES,
                         ids=[f"neg{i}" for i in range(len(NEGATIVE_LINES))])
def test_negative_line_raises_as_in_the_reference(line):
    """The mirror of ``test_reference_launch_compat.py::
    test_reference_negative_line_raises``: each expect-fail line of the
    corpus raises at construction in the port too."""
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    with pytest.raises(Exception):
        parse_launch(line)


def test_element_docs_are_current(tmp_path):
    r = run_tool("gen_element_docs_torch.py", "--check")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "is current (60 elements)" in r.stdout
    stale = tmp_path / "elements_torch.md"
    with open(os.path.join(ROOT, "docs", "elements_torch.md")) as fh:
        stale.write_text(fh.read().replace("## `tensor_sink`", "## `sink`"))
    r = run_tool("gen_element_docs_torch.py", "--check", "--out", str(stale))
    assert r.returncode == 1 and "is stale" in r.stdout


def test_entry_check_cpu_form():
    r = run_tool("entry_check_torch.py", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    got = last_json(r.stdout)
    assert got["metric"] == "graft_entry_forward"
    assert got["platform"] == "cpu" and got["bit_equal"] is True
    assert got["step_ms_p50"] > 0 and got["compile_s"] > 0


def test_device_parity_cpu_form():
    """The reference's frames (default_rng(20260730)); on the CPU both
    sides run there, so the line is exact by construction: the run checks
    the line's shape and both models' paths."""
    r = run_tool("device_parity_torch.py", "--device", "cpu", "--frames", "4")
    assert r.returncode == 0, r.stderr[-3000:]
    got = last_json(r.stdout)
    assert got["metric"] == "label_parity_torch_card_vs_cpu"
    assert (got["frames"], got["mismatches"], got["parity"]) == (4, 0, "exact")
    assert got["int8"] == {"frames": 1, "card_frames": 1, "cpu_frames": 1,
                           "mismatches": 0, "parity": "exact"}


def test_microbench_smoke_runs_every_leg_on_the_cpu(tmp_path):
    out = tmp_path / "mb.json"
    r = run_tool("microbench_overhead_torch.py", "200", "--smoke", "--device",
                 "cpu", "--json", str(out))
    # the gates' verdicts are not asserted here: 1 is a failed gate
    assert r.returncode in (0, 1), r.stderr[-3000:]
    assert "gates on cpu: " in r.stdout
    rep = json.loads(out.read_text())
    legs = ("tracing_overhead", "profiler_overhead", "placement_overhead",
            "memory_overhead", "quality_overhead", "leakcheck_overhead",
            "xfercheck_overhead", "wirefuzz_overhead")
    assert set(rep["gates"]) == {"fused_speedup", *legs}
    for leg in legs:
        keys = ({"baseline_us_per_frame", "placed_us_per_frame",
                 "placed_overhead_frac"} if leg == "placement_overhead" else
                {"baseline_us_per_frame", "enabled_us_per_frame",
                 "disabled_us_per_frame", "disabled_overhead_frac",
                 "enabled_overhead_frac"})
        assert keys <= set(rep[leg]), leg
        # the reference's four pairs, each side three runs in turn
        assert len(rep[leg]["pair_ratios"]) == 4 and rep[leg]["rounds"] == 3
    assert set(rep["noise_floor"]) == {"host chain", "fused device chain",
                                       "wire round trip"}
    for floor in rep["noise_floor"].values():
        assert len(floor["pair_ratios"]) == 4 and floor["floor"] >= 0
    for mode in ("fused", "unfused"):
        assert rep["device_chain"][mode]["n_hi"] == 8
    assert "speedup_marginal" in rep["device_chain"]
    assert rep["device_chain"]["fused"]["dispatch_host_us_8"] > 0
    assert r.stdout.count("smoke: ") == 9
    assert r.stdout.count("noise floor of the ") == 8


def test_microbench_stage_sweep_and_trace_on_the_cpu():
    """``--stage-sweep`` times both host-frame paths at every size, and
    ``--trace-fused`` reports the fused dispatch's calls, each driven on
    the profiling thread (8 transform calls a frame)."""
    sys.path.insert(0, TOOLS)
    try:
        import microbench_overhead_torch as mb
    finally:
        sys.path.remove(TOOLS)
    rows = mb.stage_sweep_report("cpu", n_bufs=8)
    assert [r["frame_bytes"] for r in rows] == list(mb.STAGE_SWEEP_BYTES)
    assert all(r["stager_us_per_frame"] > 0 and r["direct_us_per_frame"] > 0
               for r in rows)
    tr = mb.trace_fused_report("cpu", n_bufs=10)
    for name in ("host_frames", "device_frames"):
        calls = {c["name"]: c["count"] for c in tr[name]["calls"]}
        assert calls["aten::add"] == 80, calls
        assert tr[name]["dispatch_us"] > 0
