"""Bind the hand-written CUDA tree-GEMM kernel
(``repro_torch/csrc/tree_gemm.cu``, which replaces the TPU kernel
``tree_gemm_pallas``).  ``kernels/build.py`` compiles it at first use; nothing
here runs at import time."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

__all__ = ["build", "tree_gemm_cuda", "SOURCE"]

SOURCE = _build.CSRC / "tree_gemm.cu"
_MAX_SMEM = 232_448        # dynamic shared memory one block may use on Hopper


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_gemm_launch.argtypes = [p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, p]
    lib.tree_gemm_launch.restype = i
    lib.tree_gemm_smem_bytes.argtypes = [i, i]
    lib.tree_gemm_smem_bytes.restype = ctypes.c_size_t
    lib.tree_gemm_error_string.argtypes = [i]
    lib.tree_gemm_error_string.restype = ctypes.c_char_p


def tree_gemm_cuda(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, d: torch.Tensor, e: torch.Tensor,
                   out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out[N, O]`` receives the
    summed (not averaged) ensemble scores.  The caller has checked devices,
    dtypes, shapes and contiguity (``ops.tree_gemm``)."""
    lib = _build.load(SOURCE, _declare)
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
