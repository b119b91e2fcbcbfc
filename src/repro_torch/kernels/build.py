"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA source under ``repro_torch/csrc`` with a plain C
interface (sharing the headers there, ``*.cuh``).  It is compiled at first
use with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``.  The kernels are raw PTX (``wgmma``, TMA): no CUTLASS include is
needed.  The build lands in ``repro_torch/_build/`` (ignored by git) under a
name that carries the digest of the source and the headers, so an edited
source rebuilds and an unchanged one is reused; ``nvcc``'s output, with
``ptxas``'s registers, static shared memory and spills of every kernel
(``-Xptxas -v``), is kept beside the library (``ptxas_report``).  Nothing here runs at import time: the kernel modules import on a
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
import re
import threading
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load",
           "ptxas_report"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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


def _library(source: Path) -> Path:
    sha = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{sha.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` (if this version of it and of the headers has not
    been built yet) and return the library's path."""
    lib = _library(source)
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
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half
    return lib


def ptxas_report(source: Path) -> List[Dict[str, object]]:
    """Per kernel of the built ``source``: registers, static shared memory
    and spill bytes, as ``ptxas -v`` printed them at the build (the
    kernels' dynamic shared memory is set at launch and not listed)."""
    log = _library(source).with_suffix(".log").read_text()
    kernels: List[Dict[str, object]] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernels.append({"kernel": entry.group(1)})
        elif kernels:
            for key, pattern in (
                    ("registers", r"Used (\d+) registers"),
                    ("smem_static_bytes", r"(\d+) bytes smem"),
                    ("spill_stores_bytes", r"(\d+) bytes spill stores"),
                    ("spill_loads_bytes", r"(\d+) bytes spill loads")):
                found = re.search(pattern, line)
                if found:
                    kernels[-1][key] = int(found.group(1))
    return kernels


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
