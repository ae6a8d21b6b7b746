"""The ``-p torch_sanitize`` pytest plugin (tests/torch_sanitize.py) holds
itself: a child pytest loads it over a generated two-test file with one
of the port's sanitizers armed; the test that breaks that sanitizer's
contract fails, naming what it found, and the clean one (or the one
carrying the opt-out marker) passes. As with the root conftest's checks,
the failure is reported at the offending test's teardown (an ERROR
line), where every fixture of the test has released what it held."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

CASES = {
    "NNS_TSAN": ('''
        def test_reverse_order():
            a = sanitizer.named_lock("plugin.A")
            b = sanitizer.named_lock("plugin.B")
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass

        def test_clean():
            c = sanitizer.named_lock("plugin.C")
            with c:
                pass
        ''', ["plugin.A", "plugin.B", "lock-order violation"]),
    "NNS_LEAKCHECK": ('''
        def test_reverse_order():
            sanitizer.note_acquire("plugin_unit", "k1")

        @pytest.mark.leak_ok
        def test_clean():
            sanitizer.note_acquire("plugin_unit", "k2")
        ''', ["plugin_unit", "k1", "still outstanding"]),
    "NNS_WIREFUZZ": ('''
        def test_reverse_order():
            sanitizer.note_mutant("plugin_surface", "m1", "crash", "boom")

        @pytest.mark.wirefuzz_ok
        def test_clean():
            sanitizer.note_mutant("plugin_surface", "m2", "hang", "6s")
        ''', ["plugin_surface", "m1", "hostile-peer contract"]),
}


def _run(tmp_path, var, body):
    test = tmp_path / "test_generated.py"
    test.write_text("import pytest\n\nfrom nnstreamer_tpu_torch.analysis "
                    "import sanitizer\n" + textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "tests"), str(ROOT)]), **{var: "1"})
    for other in (*CASES, "NNS_XFERCHECK"):
        if other != var:
            env.pop(other, None)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "torch_sanitize",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-rA",
         "--rootdir", str(tmp_path), "-c", os.devnull, str(test)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)


def test_tsan_fails_the_reverse_order_test_naming_the_cycle(tmp_path):
    body, _ = CASES["NNS_TSAN"]
    proc = _run(tmp_path, "NNS_TSAN", body)
    out = proc.stdout
    assert proc.returncode == 1, out[-3000:] + proc.stderr[-2000:]
    assert "2 passed, 1 error" in out, out[-3000:]
    assert "ERROR test_generated.py::test_reverse_order" in out
    assert "ERROR test_generated.py::test_clean" not in out
    assert "plugin.A -> plugin.B -> plugin.A" in out \
        or "plugin.B -> plugin.A -> plugin.B" in out, out[-3000:]
    assert "torch_sanitize: nnstreamer_tpu_torch sanitizers armed: tsan" \
        in out


@pytest.mark.parametrize("var", ["NNS_LEAKCHECK", "NNS_WIREFUZZ"])
def test_each_ledger_fails_only_the_offending_test(tmp_path, var):
    body, words = CASES[var]
    proc = _run(tmp_path, var, body)
    out = proc.stdout
    assert proc.returncode == 1, out[-3000:] + proc.stderr[-2000:]
    assert "2 passed, 1 error" in out, out[-3000:]
    assert "ERROR test_generated.py::test_reverse_order" in out
    assert "ERROR test_generated.py::test_clean" not in out
    for word in words:
        assert word in out, (word, out[-3000:])


def test_unarmed_session_checks_nothing(tmp_path):
    body, _ = CASES["NNS_TSAN"]
    proc = _run(tmp_path, "NNS_UNUSED", body)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "2 passed in" in proc.stdout
    assert "armed: none" in proc.stdout
