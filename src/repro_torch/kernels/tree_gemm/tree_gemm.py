"""Bind the hand-written CUDA tree-GEMM kernel
(``repro_torch/csrc/tree_gemm.cu``, which replaces the TPU kernel
``tree_gemm_pallas``).  ``kernels/build.py`` compiles it at first use; nothing
here runs at import time."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

__all__ = ["build", "tree_gemm_cuda", "smem_bytes", "SOURCE"]

SOURCE = _build.CSRC / "tree_gemm.cu"
_MAX_SMEM = 232_448        # dynamic shared memory one block may use on Hopper


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tree_gemm_launch.argtypes = [p, p, p, p, p, p, p,
                                     i, i, i, i, i, i, i, p]
    lib.tree_gemm_launch.restype = i
    lib.tree_gemm_smem_bytes.argtypes = [i, i, i]
    lib.tree_gemm_smem_bytes.restype = ctypes.c_size_t
    lib.tree_gemm_error_string.argtypes = [i]
    lib.tree_gemm_error_string.restype = ctypes.c_char_p


def smem_bytes(n_features: int, ip: int, n_out: int) -> int:
    """Dynamic shared memory of one block (``ip``: padded internal nodes)."""
    lib = _build.load(SOURCE, _declare)
    return lib.tree_gemm_smem_bytes(n_features, ip, n_out)


def tree_gemm_cuda(x: torch.Tensor, operands, e: torch.Tensor,
                   out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out[N, O]`` receives the
    summed (not averaged) ensemble scores of ``x [N, F]`` (float32, NaN and
    ±inf already mapped), from ``operands`` (``ops.KernelOperands``) and the
    leaf values ``e [T, L, O]``.  The caller has checked devices, dtypes,
    shapes and contiguity (``ops.tree_gemm``)."""
    lib = _build.load(SOURCE, _declare)
    n, nf = x.shape
    nt, lp, ip = operands.ct.shape
    nl, no = e.shape[1], e.shape[2]
    smem = lib.tree_gemm_smem_bytes(nf, ip, no)
    if smem > _MAX_SMEM:
        raise ValueError(f"tree_gemm: {nf} features, {ip} padded nodes and "
                         f"{no} outputs need {smem} B of shared memory per "
                         f"block; the card has {_MAX_SMEM}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tree_gemm_launch(
            x.data_ptr(), operands.feat.data_ptr(), operands.b.data_ptr(),
            operands.ct.data_ptr(), operands.d.data_ptr(), e.data_ptr(),
            out.data_ptr(), n, nf, nt, ip, lp, nl, no, stream)
    if err != 0:
        raise RuntimeError(f"tree_gemm launch failed: "
                           f"{lib.tree_gemm_error_string(err).decode()}")
