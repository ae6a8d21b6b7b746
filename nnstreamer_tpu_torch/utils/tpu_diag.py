"""Staged, diagnostic CUDA-init probe (the counterpart of nnstreamer_tpu's
``utils/tpu_diag.py``, kept at the same path).

:mod:`.hw_accel` answers *whether* the card is there; this module answers
*where start-up gets stuck when it does not come up in time*. A plain
timeout learns nothing but elapsed time, so the probe runs a child
process that prints a marker line after each stage of bringing the card
up:

1. ``import_torch`` — ``import torch``;
2. ``cuda_init`` — ``torch.cuda.is_available()`` and ``torch.cuda.init()``
   (the driver and the runtime);
3. ``devices`` — every card's name and compute capability;
4. ``compute`` — a first product on ``cuda:0``, synchronized and checked;
5. ``kernel_build`` — the first hand-written kernel (``csrc/
   decode_attention.cu``) built through ``ops/build.py`` (or found built)
   and loaded;

then ``done``. ``faulthandler`` dumps the child's Python stacks every
``dump_every_s`` seconds, so a hang leaves the blocked frame on stderr. On
a timeout the parent kills the child and folds the stage log, the last
stack dump and the stderr tail into one record; a stage that fails ends
the child with an ``error`` record naming it. ``tcp_probe`` checks a TCP
endpoint in about a millisecond (refused / open / timeout) — a
coordinator's ``NNS_COORD``, say; ``staged_probe(addr=...)`` adds it to
the record.

``NNS_DIAG_FORCE_PLATFORM=cpu`` in ``env_overrides`` runs the compute stage
on the CPU and skips the kernel build: the tests' way to walk every stage
on a machine without a card. Without it, a machine without a card ends at
``cuda_init`` with outcome ``error``.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

_STAGE_MARK = "NNS_DIAG "
_ROOT = Path(__file__).resolve().parents[2]

# Child source: marker-prefixed JSON stage lines on stdout, faulthandler
# stacks on stderr. The stage order is the contract the parent's hang
# attribution relies on.
_CHILD_SRC = r'''
import faulthandler, json, os, sys, time
T0 = time.monotonic()
def stage(name, **kw):
    kw.update(stage=name, t=round(time.monotonic() - T0, 3))
    sys.stdout.write("\n" + @MARK@ + json.dumps(kw) + "\n")
    sys.stdout.flush()
faulthandler.enable()
# periodic stacks: a hang leaves evidence naming the blocked frame
faulthandler.dump_traceback_later(@DUMP@, repeat=True)
stage("start", env={k: v for k, v in os.environ.items()
                    if k.split("_")[0] in ("CUDA", "NVIDIA", "NNS", "TORCH")})
import torch
stage("import_torch", version=torch.__version__, cuda=torch.version.cuda)
forced = os.environ.get("NNS_DIAG_FORCE_PLATFORM") == "cpu"
available = torch.cuda.is_available()
if not available and not forced:
    stage("error", failed="cuda_init",
          reason="torch.cuda.is_available() is False")
    sys.exit(3)
if available and not forced:
    torch.cuda.init()
stage("cuda_init", available=available, forced_cpu=forced)
if forced:
    stage("devices", n=0, platform="cpu", kinds=[])
else:
    n = torch.cuda.device_count()
    stage("devices", n=n, platform="cuda",
          kinds=sorted({torch.cuda.get_device_name(i) for i in range(n)}),
          capability=[list(torch.cuda.get_device_capability(i))
                      for i in range(n)])
dev = torch.device("cpu" if forced else "cuda:0")
a = torch.ones((128, 128), device=dev, dtype=torch.bfloat16)
y = a @ a
if dev.type == "cuda":
    torch.cuda.synchronize(dev)
stage("compute", ok=bool(float(y[0, 0]) == 128.0))
if forced:
    stage("kernel_build", skipped="cpu platform")
else:
    sys.path.insert(0, @ROOT@)
    from nnstreamer_tpu_torch.ops import build
    lib = build.library_path("decode_attention")
    built = not lib.exists()
    build.build_kernels(["decode_attention"])
    build.load_kernel("decode_attention")
    stage("kernel_build", kernel="decode_attention", built=built,
          library=str(lib))
stage("done")
'''

# stage N seen but not N+1  =>  hung inside N+1's work
_STAGE_ORDER = ["start", "import_torch", "cuda_init", "devices", "compute",
                "kernel_build", "done"]
_HANG_NAME = {
    "start": "python startup",
    "import_torch": "import torch",
    "cuda_init": "CUDA init (driver and runtime, torch.cuda.init())",
    "devices": "device enumeration",
    "compute": "first compute (a product on cuda:0, synchronized)",
    "kernel_build": "first hand-kernel build (ops/build.py, nvcc)",
    "done": "-",
}


def tcp_probe(addr: Tuple[str, int], timeout_s: float = 2.0
              ) -> Dict[str, Any]:
    """A quick liveness check of a TCP endpoint: ``refused`` (nothing
    listens), ``open`` (something answers), ``timeout`` (filtered or
    black-holed) or ``error:<errno>``."""
    t0 = time.monotonic()
    s = socket.socket()
    s.settimeout(timeout_s)
    try:
        s.connect(addr)
        state = "open"
    except ConnectionRefusedError:
        state = "refused"
    except socket.timeout:
        state = "timeout"
    except OSError as e:
        state = f"error:{e.errno}"
    finally:
        s.close()
    return {"addr": "%s:%d" % addr, "state": state,
            "ms": round((time.monotonic() - t0) * 1e3, 1)}


def _last_traceback(stderr_text: str, max_chars: int = 2500) -> Optional[str]:
    """The LAST faulthandler dump in the stream — the stack at kill time,
    i.e. the blocked frame."""
    marker = "Timeout (0:"
    idx = stderr_text.rfind(marker)
    if idx < 0:
        return None
    return stderr_text[idx:idx + max_chars]


def staged_probe(timeout_s: float = 300.0, dump_every_s: float = 30.0,
                 addr: Optional[Tuple[str, int]] = None,
                 env_overrides: Optional[Dict[str, str]] = None
                 ) -> Dict[str, Any]:
    """Run the staged child probe; always returns a record.

    Keys: ``tcp`` (``tcp_probe(addr)``, only with ``addr``), ``stages``
    (the child's stage records, as far as it got, each with ``t``, its
    seconds since the child started), ``seconds`` (each reached stage's
    own seconds), ``platform`` (None unless the child proved compute),
    ``outcome`` (``ok`` / ``hang`` / ``error``), ``hung_in`` (the stage
    the child was in at the timeout), ``failed`` (the stage that failed,
    on ``error``), ``last_stack`` (the faulthandler dump at the kill),
    ``stderr_tail``.
    """
    rec: Dict[str, Any] = {"timeout_s": timeout_s}
    if addr is not None:
        rec["tcp"] = tcp_probe(addr)
    env = dict(os.environ)
    if env_overrides:
        env.update(env_overrides)
    src = (_CHILD_SRC.replace("@MARK@", repr(_STAGE_MARK))
           .replace("@DUMP@", repr(float(dump_every_s)))
           .replace("@ROOT@", repr(str(_ROOT))))
    t0 = time.monotonic()
    with tempfile.TemporaryFile() as out_f, tempfile.TemporaryFile() as err_f:
        proc = subprocess.Popen([sys.executable, "-c", src], env=env,
                                stdout=out_f, stderr=err_f)
        try:
            rc: Optional[int] = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
            proc.send_signal(signal.SIGTERM)  # faulthandler already dumped
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        rec["elapsed_s"] = round(time.monotonic() - t0, 3)
        out_f.seek(0)
        err_f.seek(0)
        out_text = out_f.read().decode(errors="replace")
        err_text = err_f.read().decode(errors="replace")

    stages = []
    for line in out_text.splitlines():
        if line.startswith(_STAGE_MARK):
            try:
                stages.append(json.loads(line[len(_STAGE_MARK):]))
            except ValueError:
                pass
    rec["stages"] = stages
    seen = [s["stage"] for s in stages]
    prev, rec["seconds"] = 0.0, {}
    for s in stages:
        if s["stage"] in _STAGE_ORDER:
            rec["seconds"][s["stage"]] = round(s["t"] - prev, 3)
            prev = s["t"]
    rec["platform"] = None
    if "done" in seen and rc == 0:
        rec["outcome"] = "ok"
        rec["platform"] = next(s.get("platform") for s in stages
                               if s["stage"] == "devices")
    elif rc is None:
        rec["outcome"] = "hang"
        n_seen = len([s for s in _STAGE_ORDER if s in seen])
        nxt = _STAGE_ORDER[n_seen] if n_seen < len(_STAGE_ORDER) else "done"
        rec["hung_in"] = _HANG_NAME.get(nxt, nxt)
        rec["last_stack"] = _last_traceback(err_text)
    else:
        rec["outcome"] = "error"
        rec["rc"] = rc
        failed = [s for s in stages if s["stage"] == "error"]
        n_seen = len([s for s in _STAGE_ORDER if s in seen])
        rec["failed"] = (failed[0]["failed"] if failed else
                         _STAGE_ORDER[min(n_seen, len(_STAGE_ORDER) - 1)])
    rec["stderr_tail"] = err_text[-2000:] if rec["outcome"] != "ok" else None
    return rec


def main() -> None:  # pragma: no cover - CLI convenience
    timeout = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    print(json.dumps(staged_probe(timeout_s=timeout), indent=1))


if __name__ == "__main__":  # pragma: no cover
    main()
