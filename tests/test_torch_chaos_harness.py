"""The port's chaos harness (tools/chaos_torch.py) end to end: its smoke
set — replica-kill, conn-kill, load-ramp, proc-replica-kill,
shm-peer-kill and wire-corruption, the reference tool's ``--smoke``
list — runs once in a child process on the CPU under the port's lock
sanitizer (``NNS_TSAN=1``) and leak ledger (``NNS_LEAKCHECK=1``). Every
scenario must pass its gate with zero client-visible errors, and the
sanitizer must record no lock-order violation and no outstanding
acquisition."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "chaos_torch.py"
SMOKE = ["replica-kill", "conn-kill", "load-ramp", "proc-replica-kill",
         "shm-peer-kill", "wire-corruption"]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("chaos") / "chaos.json"
    env = dict(os.environ, NNS_TSAN="1", NNS_LEAKCHECK="1",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(TOOL), "--smoke", "--device", "cpu",
         "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=420)
    report = json.loads(out.read_text()) if out.exists() else None
    return proc, report


def test_smoke_run_exits_zero_with_a_report(smoke):
    proc, report = smoke
    assert report is not None, proc.stderr[-4000:]
    assert proc.returncode == 0, (json.dumps(report, indent=1)[-4000:]
                                  + proc.stderr[-2000:])
    assert report["ok"] is True
    assert list(report["scenarios"]) == SMOKE
    assert report["device"] == "cpu"


@pytest.mark.parametrize("scenario", SMOKE)
def test_scenario_has_zero_client_visible_errors(smoke, scenario):
    _, report = smoke
    res = report["scenarios"][scenario]
    assert res["errors"] == [], res["errors"][:5]
    assert res["requests"] > 0
    assert res["ok"] is True, res
    assert res["p99_s"] > 0


def test_the_port_sanitizer_records_nothing(smoke):
    """Both halves were armed (the keys exist) and stayed empty."""
    _, report = smoke
    assert report["tsan_violations"] == []
    assert report["leak_outstanding"] == []


def test_failover_paths_were_exercised(smoke):
    """The faults really happened: a replica left the pool and came back,
    connections were killed, the autoscaler moved both ways, a process
    replica was respawned, the ring reclaimed its slots and the catalog's
    poisoned frames were all typed or clean."""
    _, report = smoke
    sc = report["scenarios"]
    assert sc["replica-kill"]["evictions"] >= 1
    assert sc["replica-kill"]["readmissions"] >= 1
    assert sc["conn-kill"]["conns_killed"] >= 1
    assert sc["load-ramp"]["scale_out_events"] >= 1
    assert sc["load-ramp"]["scale_in_events"] >= 1
    assert sc["proc-replica-kill"]["respawns"] >= 1
    assert sc["proc-replica-kill"]["devices"] == ["cpu"]
    ring = sc["shm-peer-kill"]["ring_recovery"]
    assert ring["reclaimed"] == ring["stale_descriptors_typed"] == 2
    assert sc["shm-peer-kill"]["fleet"]["wire_after"] == \
        ["binary+shm", "binary+shm"]
    wire = sc["wire-corruption"]
    assert wire["untyped"] == [] and wire["leaked"] == []
    assert wire["typed"] + wire["clean"] == wire["mutants_injected"]
