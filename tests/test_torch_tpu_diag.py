"""The port's staged CUDA-init probe (``utils/tpu_diag.py``) against
nnstreamer_tpu's (mirrors ``tests/test_tpu_diag.py``): the TCP probe's
record, every stage walked and the platform reported when start-up works
(the compute stage forced onto the CPU here), the stage named on a hang,
the failing stage named on a machine without a card, and the last stack
dump picked from a stream.
"""
import socket
import threading

from nnstreamer_tpu.utils import tpu_diag as ref
from nnstreamer_tpu_torch.utils.tpu_diag import (
    _last_traceback,
    staged_probe,
    tcp_probe,
)


def test_tcp_probe_refused():
    rec = tcp_probe(("127.0.0.1", 1), timeout_s=1.0)
    assert set(rec) == set(ref.tcp_probe(("127.0.0.1", 1), 1.0))
    assert rec["state"] == "refused"
    assert rec["addr"] == "127.0.0.1:1"
    assert rec["ms"] < 500


def test_tcp_probe_open():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    srv.settimeout(2.0)
    stop = threading.Event()

    def accept_loop():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
                conn.close()
            except OSError:
                break

    t = threading.Thread(target=accept_loop, daemon=True)
    t.start()
    try:
        assert tcp_probe(("127.0.0.1", port), timeout_s=2.0)["state"] == "open"
    finally:
        stop.set()
        srv.close()
        t.join(timeout=5)
    assert not t.is_alive()


def test_staged_probe_ok_with_the_compute_forced_onto_the_cpu():
    rec = staged_probe(timeout_s=120.0, addr=("127.0.0.1", 1),
                       env_overrides={"NNS_DIAG_FORCE_PLATFORM": "cpu"})
    assert rec["outcome"] == "ok", rec
    assert rec["platform"] == "cpu"
    assert rec["tcp"]["state"] == "refused"
    names = [s["stage"] for s in rec["stages"]]
    assert names == ["start", "import_torch", "cuda_init", "devices",
                     "compute", "kernel_build", "done"]
    assert set(rec["seconds"]) == set(names)
    assert all(v >= 0 for v in rec["seconds"].values())
    compute = [s for s in rec["stages"] if s["stage"] == "compute"][0]
    assert compute["ok"] is True
    assert rec["stderr_tail"] is None


def test_staged_probe_without_a_card_fails_at_cuda_init():
    rec = staged_probe(timeout_s=120.0,
                       env_overrides={"CUDA_VISIBLE_DEVICES": ""})
    assert rec["outcome"] == "error", rec
    assert rec["failed"] == "cuda_init"
    assert rec["platform"] is None
    assert [s["stage"] for s in rec["stages"]][:2] == ["start",
                                                      "import_torch"]


def test_staged_probe_names_the_hung_stage():
    # well above bare interpreter start-up and well below `import torch`
    rec = staged_probe(timeout_s=0.15,
                       env_overrides={"NNS_DIAG_FORCE_PLATFORM": "cpu"})
    assert rec["outcome"] == "hang"
    assert rec["platform"] is None
    assert rec["hung_in"] in ("python startup", "import torch")


def test_last_traceback_extracts_the_final_dump():
    text = ("noise\nTimeout (0:00:30)!\nThread X:\n  File \"a.py\"\n"
            "more\nTimeout (0:01:00)!\nThread X:\n  File \"b.py\"\n")
    out = _last_traceback(text)
    assert out == ref._last_traceback(text)
    assert out.startswith("Timeout (0:01:00)!")
    assert "b.py" in out
    assert _last_traceback("no dumps here") is None
