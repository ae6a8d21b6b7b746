"""Build-on-demand loader for the native (C++) host libraries.

One implementation of the compile / atomic-publish / ABI-check sequence,
used by ``libnns_core`` (``__init__.py``) and ``libnns_q8`` (``q8.py``).
Each library is compiled with ``g++`` from ``csrc/`` into ``build/native/``
beside the package, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused; nothing is built
into the package tree. Concurrent processes may race to build: building
to a temp path and publishing with ``os.replace`` keeps every reader
consistent. Callers keep their own per-module cache and failure latch and
call :func:`load_once` under their own lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

from ..utils.log import logger

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
             "-fvisibility=hidden")

# compiler output per library (empty on success without warnings)
build_logs: Dict[str, str] = {}


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path(src: Path, extra_args: Sequence[str] = ()) -> Path:
    flags = " ".join((_cxx(),) + CXX_FLAGS + tuple(extra_args))
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build(src: Path, lib_path: Path, extra_args: Sequence[str] = (),
          timeout: float = 180.0) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src), *extra_args]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        build_logs[src.stem] = proc.stderr
        if proc.returncode != 0:
            logger.warning("native build failed (%s):\n%s", src.name,
                           proc.stderr)
            return False
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing/hung
        logger.warning("native build unavailable (%s): %s", src.name, e)
        return False
    finally:
        # a failed/killed compile leaves its partial -o output behind
        try:
            os.remove(tmp)
        except OSError:
            pass


def load_once(name: str, abi_version: int, abi_symbol: str,
              bind: Callable[[ctypes.CDLL], None],
              extra_args: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """Build ``csrc/<name>.cc`` if its library is missing, dlopen it,
    check its ABI and bind it. Returns the bound library or None; the
    caller latches the failure."""
    src = CSRC / f"{name}.cc"
    lib_path = library_path(src, extra_args)
    if not lib_path.exists() and not build(src, lib_path, extra_args):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        logger.warning("native load failed (%s): %s", lib_path.name, e)
        return None
    abi_fn = getattr(lib, abi_symbol)
    abi_fn.restype = ctypes.c_uint64
    if abi_fn() != abi_version:
        logger.warning("native ABI mismatch (%s); disabling for this "
                       "process", lib_path.name)
        return None
    bind(lib)
    return lib
