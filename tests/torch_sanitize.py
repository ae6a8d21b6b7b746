"""pytest plugin: run a session under nnstreamer_tpu_torch's own runtime
sanitizers (``nnstreamer_tpu_torch.analysis.sanitizer``).

The root ``conftest.py`` arms only nnstreamer_tpu's sanitizer from the
``NNS_*`` variables below; this plugin arms the port's matching halves
from the same variables and fails a test that leaves new findings in the
port's ledgers, as the conftest does for the reference:

* ``NNS_TSAN=1`` (``NNS_TSAN_HOLD_S``, default 5): the lock-order
  sanitizer; a test fails on any new lock-order violation (a cycle in
  the observed acquisition graph), naming the cycle.
* ``NNS_LEAKCHECK=1``: the paired-resource ledger; a test fails when
  acquisitions it made are still outstanding after a 2 s grace window.
  ``@pytest.mark.leak_ok`` opts out; ``@pytest.mark.thread_leak_ok``
  exempts its ``tracked_thread`` rows (the threads it keeps on purpose).
* ``NNS_XFERCHECK=1``: the transfer byte ledger; a test fails on a new
  transfer violation (``@pytest.mark.xfer_ok`` opts out). PyTorch has no
  transfer guard, so the port records none; the pass drives every
  accounted copy path with the ledger on.
* ``NNS_WIREFUZZ=1``: the frame-fuzz scorekeeper; a test fails on a new
  hostile-peer contract violation (``@pytest.mark.wirefuzz_ok`` opts
  out).

It is loaded by name, never collected and not a conftest::

    PYTHONPATH=tests NNS_TSAN=1 python -m pytest -p torch_sanitize \\
        tests/test_torch_fabric.py

It arms at import, before any test module builds a port object, so every
named lock and ledger entry of the session is instrumented.
"""
import os
import time

import pytest

from nnstreamer_tpu_torch.analysis import sanitizer as _san

TSAN = os.environ.get("NNS_TSAN", "") == "1"
LEAKCHECK = os.environ.get("NNS_LEAKCHECK", "") == "1"
XFERCHECK = os.environ.get("NNS_XFERCHECK", "") == "1"
WIREFUZZ = os.environ.get("NNS_WIREFUZZ", "") == "1"

if TSAN:
    _san.enable(hold_warn_s=float(os.environ.get("NNS_TSAN_HOLD_S", "5")))
if LEAKCHECK:
    _san.enable_leakcheck()
if XFERCHECK:
    _san.enable_xfercheck()
if WIREFUZZ:
    _san.enable_wirefuzz()

_MARKERS = {
    "leak_ok": "opt out of the per-test NNS_LEAKCHECK zero-outstanding-"
               "resources check",
    "xfer_ok": "opt out of the per-test NNS_XFERCHECK check",
    "wirefuzz_ok": "opt out of the per-test NNS_WIREFUZZ zero-contract-"
                   "violations check",
    "thread_leak_ok": "opt out of the per-test leaked-thread checks",
}


def pytest_configure(config):
    for name, doc in _MARKERS.items():
        config.addinivalue_line("markers", f"{name}: {doc}")


def pytest_report_header(config):
    armed = [name for name, on in (("tsan", TSAN), ("leakcheck", LEAKCHECK),
                                   ("xfercheck", XFERCHECK),
                                   ("wirefuzz", WIREFUZZ)) if on]
    return ("torch_sanitize: nnstreamer_tpu_torch sanitizers armed: "
            + (", ".join(armed) or "none"))


@pytest.fixture(autouse=True)
def _torch_tsan_check(request):
    """Under NNS_TSAN=1: fail a test during which the port's sanitizer
    observed a lock-order violation."""
    if not TSAN:
        yield
        return
    before = len(_san.violations())
    yield
    fresh = _san.violations()[before:]
    assert not fresh, (
        f"torch tsan-lite: {len(fresh)} lock-order violation(s) during "
        "this test: " + "; ".join(
            " -> ".join(v["cycle"]) + f" at {v['site']}" for v in fresh))


@pytest.fixture(autouse=True)
def _torch_leakcheck(request):
    """Under NNS_LEAKCHECK=1: fail a test that ends with port resources
    still outstanding beyond its entry baseline (2 s grace for
    teardown-time releases)."""
    if not LEAKCHECK or request.node.get_closest_marker("leak_ok"):
        yield
        return
    skip_threads = request.node.get_closest_marker("thread_leak_ok")

    def keyed():
        return {(r["kind"], r["key"]): r["count"]
                for r in _san.outstanding()
                if not (skip_threads and r["kind"] == "tracked_thread")}

    before = keyed()
    yield

    def fresh():
        return [{"kind": k, "key": key, "count": c}
                for (k, key), c in keyed().items()
                if c > before.get((k, key), 0)]

    deadline = time.monotonic() + 2.0
    rest = fresh()
    while rest and time.monotonic() < deadline:
        time.sleep(0.05)
        rest = fresh()
    assert not rest, (
        f"torch leakcheck: {len(rest)} paired resource(s) still "
        f"outstanding after this test (acquire without release): {rest}")


@pytest.fixture(autouse=True)
def _torch_xfercheck(request):
    """Under NNS_XFERCHECK=1: fail a test that recorded a new transfer
    violation in the port's ledger."""
    if not XFERCHECK or request.node.get_closest_marker("xfer_ok"):
        yield
        return
    before = len(_san.xfer_violations())
    yield
    fresh = _san.xfer_violations()[before:]
    assert not fresh, (
        f"torch xfercheck: {len(fresh)} transfer violation(s) during this "
        f"test: {fresh}")


@pytest.fixture(autouse=True)
def _torch_wirefuzz_check(request):
    """Under NNS_WIREFUZZ=1: fail a test during which a fuzzed mutant
    broke the port's hostile-peer contract (hang, crash or silent wrong
    decode)."""
    if not WIREFUZZ or request.node.get_closest_marker("wirefuzz_ok"):
        yield
        return
    before = len(_san.wirefuzz_violations())
    yield
    fresh = _san.wirefuzz_violations()[before:]
    assert not fresh, (
        f"torch wirefuzz: {len(fresh)} hostile-peer contract violation(s) "
        f"during this test: {fresh}")
