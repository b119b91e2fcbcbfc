"""Bind the hand-written CUDA SSD kernel (``repro_torch/csrc/ssd_scan.cu``,
which replaces the TPU kernel ``ssd_scan_pallas``).  ``kernels/build.py``
compiles it at first use; nothing here runs at import time."""

from __future__ import annotations

import ctypes
from pathlib import Path
import torch

from .. import build as _build

__all__ = ["build", "ssd_scan_cuda", "scratch_floats", "CHUNK", "SOURCE"]

SOURCE = _build.CSRC / "ssd_scan.cu"
CHUNK = 64              # the kernel's chunk length (Q in the source)


def scratch_floats(b: int, s: int, h: int, p: int, n: int) -> int:
    """Float32 elements of the scratch the kernel's passes share: each
    chunk's local state [P,N] (then the state entering it) and its summed
    decay exponent."""
    n_chunks = -(-s // CHUNK)
    return b * h * n_chunks * (p * n + 1)


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p, p, p, p, p, i, ll, ll, ll, p, p, p,
                                    ll, i, i, i, i, i, p]
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  bmat: torch.Tensor, cmat: torch.Tensor, y: torch.Tensor,
                  h_out: torch.Tensor, scratch: torch.Tensor) -> None:
    """Launch the kernel's three passes on the current stream, writing ``y``
    and ``h_out`` (float32, contiguous) and using ``scratch`` (float32, at
    least ``scratch_floats`` elements).  x, dt, bmat and cmat share one
    dtype, float32 or bfloat16, and a is float32, on one card; dt and a are
    contiguous, and x, bmat and cmat contiguous within a token with one row
    stride between tokens (``ops._rows``); the caller has checked shapes and
    dtypes (``ops.ssd_scan``)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if scratch.dtype != torch.float32 \
            or scratch.numel() < scratch_floats(b, s, h, p, n):
        raise ValueError(f"ssd_scan: scratch must hold "
                         f"{scratch_floats(b, s, h, p, n)} float32")
    lib = _build.load(SOURCE, _declare)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(1),
            bmat.stride(1), cmat.stride(1), y.data_ptr(), h_out.data_ptr(),
            scratch.data_ptr(), scratch.numel(), b, s, h, p, n, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
