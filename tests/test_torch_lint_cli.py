"""The port's lint CLI (``analysis/cli.py``, the ``lint`` verb) against
nnstreamer_tpu's: the rule catalog, ``--json``, ``--rules``, the exit
codes, and the strict self-lint gate of the port tree (mirroring the
reference's ``tests/test_lint.py`` TestCli and TestSelfLint)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nnstreamer_tpu.analysis import RULES as REF_RULES
from nnstreamer_tpu.analysis.cli import main as ref_main
from nnstreamer_tpu_torch.analysis import RULES, lint_source
from nnstreamer_tpu_torch.analysis.cli import main as lint_main

ROOT = Path(__file__).resolve().parent.parent
# every element named: an unnamed one takes its package's running
# counter, which differs between the two packages in one process
TEE = "tensor_src name=s num-buffers=1 ! tee name=t t. ! tensor_sink name=o"


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _findings(out: str):
    return [(d["rule"], d["severity"], d.get("location"))
            for d in json.loads(out)]


def test_catalog_equals_the_references():
    assert list(RULES) == list(REF_RULES)
    for rid, rule in RULES.items():
        ref = REF_RULES[rid]
        assert (rule.severity.value, rule.title) == \
            (ref.severity.value, ref.title)


@pytest.mark.parametrize("argv,rc", [
    (["--strict", "tensor_sr ! tensor_sink"], 1),
    (["tensor_src num-buffers=1 ! tensor_sink"], 0),
    ([TEE], 0),
    (["--strict", TEE], 1),
    (["--rules"], 0),
    (["--rules", "list,NNL3xx"], 0),
])
def test_exit_codes_and_output_equal_the_references(capsys, argv, rc):
    got_rc, got = _run(lint_main, list(argv), capsys)
    want_rc, want = _run(ref_main, list(argv), capsys)
    assert got_rc == want_rc == rc
    # the catalog's rationale lines may word the port's own mechanism
    # (NNL015 names torch.export); the finding and header lines are equal
    assert [ln for ln in got.splitlines() if not ln.startswith("    ")] == \
        [ln for ln in want.splitlines() if not ln.startswith("    ")]


def test_rules_listing_names_every_rule(capsys):
    rc, out = _run(lint_main, ["--rules"], capsys)
    assert rc == 0
    for rule_id in RULES:
        assert rule_id in out
    rc, out = _run(lint_main, ["--rules", "list,NNL4xx"], capsys)
    assert [ln.split()[0] for ln in out.splitlines()
            if ln.startswith("NNL")] == [
        "NNL401", "NNL402", "NNL403", "NNL404", "NNL405"]


@pytest.mark.parametrize("line", [
    "tensor_sr ! tensor_sink",
    TEE,
    "tensor_src name=s num-buffers=2 dimensions=4 types=float32 ! "
    "tensor_transform name=t mode=arithmetic option=add:1 accelerator=cpu ! "
    "tensor_filter name=f framework=torch accelerator=cpu "
    "model=builtin://scaler?factor=2 ! tensor_sink name=o",
])
def test_json_findings_equal_the_references(capsys, line):
    # the reference's line: its jax backend, and no accelerator= (its
    # transform has none; it runs on the CPU in the tests)
    ref_line = line.replace("framework=torch", "framework=jax").replace(
        " accelerator=cpu", "")
    rc, out = _run(lint_main, ["--json", line], capsys)
    want_rc, want = _run(ref_main, ["--json", ref_line], capsys)
    assert rc == want_rc
    assert _findings(out) == _findings(want)


def test_json_target_with_non_dict_top_level(tmp_path, capsys):
    f = tmp_path / "bad.json"
    f.write_text("[1, 2, 3]")
    assert lint_main([str(f)]) == 1   # an NNL012 finding, no traceback
    assert "NNL012" in capsys.readouterr().out


def test_rules_filter_on_a_source_dir(tmp_path, capsys):
    d = tmp_path / "elements"
    d.mkdir()
    (d / "mod.py").write_text(
        "import threading\n\n"
        "class El:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def chain(self, pad, buf):\n"
        "        try:\n"
        "            with self._lock:\n"
        "                buf.cpu()\n"
        "        except:\n"
        "            pass\n")
    argv = ["--json", str(d)]
    rc, out = _run(lint_main, argv, capsys)
    assert rc == 1  # NNL103 is an error
    assert {f[0] for f in _findings(out)} >= {"NNL101", "NNL103"}
    rc, out = _run(lint_main, argv + ["--rules", "NNL2xx,NNL103"], capsys)
    assert {f[0] for f in _findings(out)} == {"NNL103"}
    rc, out = _run(lint_main, argv + ["--rules", "NNL101"], capsys)
    assert rc == 0 and {f[0] for f in _findings(out)} == {"NNL101"}


def test_a_launch_line_longer_than_a_file_name(capsys):
    line = ("tensor_src num-buffers=1 dimensions=4 ! "
            + " ! ".join(["queue"] * 40) + " ! tensor_sink")
    assert len(line) > 255
    assert lint_main([line]) == 0
    capsys.readouterr()


def test_module_entrypoint():
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch", "lint",
         "tensor_src num-buffers=1 ! tensor_sink"],
        capture_output=True, text=True, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "HOME": os.environ.get("HOME", "/tmp"),
             "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    assert "lint: 0 error(s)" in proc.stdout


@pytest.mark.lint
class TestSelfLint:
    def test_tree_has_zero_findings(self):
        import nnstreamer_tpu_torch

        pkg = Path(nnstreamer_tpu_torch.__file__).parent
        diags = lint_source([pkg], root=str(pkg.parent))
        assert [d.format() for d in diags] == []

    def test_strict_cli_gate_passes(self, capsys):
        """No target: the strict self-lint of the port tree, all five
        source passes."""
        assert lint_main([]) == 0
        assert "lint: 0 error(s), 0 warning(s), 0 info" in \
            capsys.readouterr().out
