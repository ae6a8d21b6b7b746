"""Build and load the package's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go to
``build/kernels/`` beside the package, named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused. The first
launch of a kernel builds it; ``build_kernels()`` builds every source at once,
one ``nvcc`` per source, all started together.

``attach_library_cache(dir)`` (the AOT cache's ``xla/``,
``aot.attach_xla_cache``) adds a second place: a library missing from
``build/kernels/`` is taken from there instead of being rebuilt, and a
new build is copied there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("decode_attention", "flash_attention", "fma_gemm",
           "depthwise_fma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # guarded-by: _lock
# compiler output (ptxas register and shared-memory report) per kernel
build_logs: Dict[str, str] = {}
# a shared directory of built libraries (attach_library_cache)
_attached: Optional[Path] = None


def attach_library_cache(directory) -> None:
    """Take missing libraries from ``directory`` and copy new builds
    there (names carry the source's hash, so a stale one is never
    picked)."""
    global _attached
    _attached = Path(directory)


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all in parallel.
    Raises RuntimeError with the compiler's output if one fails."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    shared = _attached
    todo = []
    for n in names:
        if out[n].exists():
            continue
        if shared is not None and (shared / out[n].name).exists():
            out[n] = shared / out[n].name
        else:
            todo.append(n)
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        # nnlint: disable=NNL203 — one build at a time: the lock keeps two
        # threads from running nvcc on the same sources; every source of a
        # build starts at once and the lock is held until all end
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            try:
                os.replace(tmp, out[n])  # atomic: a loader sees all or nothing
            except OSError:
                tmp.unlink(missing_ok=True)
                raise
            if shared is not None:
                shared.mkdir(parents=True, exist_ok=True)
                copy = shared / f"{out[n].name}.{os.getpid()}.tmp"
                try:
                    shutil.copy2(out[n], copy)
                    os.replace(copy, shared / out[n].name)
                except OSError:
                    copy.unlink(missing_ok=True)
                    raise
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build_kernels([name])[name]))
        return lib
