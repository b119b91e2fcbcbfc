"""Build and bind the hand-written CUDA tree-GEMM kernel
(``repro_torch/csrc/tree_gemm.cu``, which replaces the TPU kernel
``tree_gemm_pallas``).

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
lands in ``repro_torch/_build/`` (ignored by git) under a name that carries
the source's digest, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time: this module imports on a machine
with no ``nvcc`` and no card, where only the plain version is reachable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

__all__ = ["build", "tree_gemm_cuda", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "tree_gemm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_MAX_SMEM = 232_448        # dynamic shared memory one block may use on Hopper

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA tree-GEMM kernel is "
                           "built at first use and needs the CUDA toolkit")
    return path


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libtree_gemm_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)       # atomic: a concurrent build never sees half
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tree_gemm_launch.argtypes = [p, p, p, p, p, p, p,
                                         i, i, i, i, i, i, p]
        lib.tree_gemm_launch.restype = i
        lib.tree_gemm_smem_bytes.argtypes = [i, i]
        lib.tree_gemm_smem_bytes.restype = ctypes.c_size_t
        lib.tree_gemm_error_string.argtypes = [i]
        lib.tree_gemm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def tree_gemm_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, d: torch.Tensor, e: torch.Tensor,
                   out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out[N, O]`` receives the
    summed (not averaged) ensemble scores.  The caller has checked devices,
    dtypes, shapes and contiguity (``ops.tree_gemm``)."""
    lib = _library()
    n, nf = x.shape
    nt, _, ni = a.shape
    nl, no = c.shape[2], e.shape[2]
    smem = lib.tree_gemm_smem_bytes(nf, no)
    if smem > _MAX_SMEM:
        raise ValueError(f"tree_gemm: {nf} features x {no} outputs need "
                         f"{smem} B of shared memory per block; the card "
                         f"has {_MAX_SMEM}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tree_gemm_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            d.data_ptr(), e.data_ptr(), out.data_ptr(),
            n, nf, nt, ni, nl, no, stream)
    if err != 0:
        raise RuntimeError(f"tree_gemm launch failed: "
                           f"{lib.tree_gemm_error_string(err).decode()}")
