"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA source under ``repro_torch/csrc`` with a plain C
interface.  It is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library and loaded with ``ctypes``.  The build lands in
``repro_torch/_build/`` (ignored by git) under a name that carries the
source's digest, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the kernel modules import on a
machine with no ``nvcc`` and no card, where only their plain versions are
reachable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def build(source: Path) -> Path:
    """Compile ``source`` (if this version of it has not been built yet)
    and return the library's path."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half
    return lib


def load(source: Path, declare: Callable[[ctypes.CDLL], None]
         ) -> ctypes.CDLL:
    """Build ``source`` and load it once per process; ``declare`` sets the
    ``argtypes`` and ``restype`` of every entry point on first load."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _loaded[source] = lib
        return lib
