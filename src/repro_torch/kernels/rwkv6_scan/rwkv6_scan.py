"""Bind the hand-written CUDA WKV6 kernel (``repro_torch/csrc/
rwkv6_scan.cu``, which replaces the TPU kernel ``rwkv6_scan_pallas``).
``kernels/build.py`` compiles it at first use; nothing here runs at import
time."""

from __future__ import annotations

import ctypes
from pathlib import Path
import torch

from .. import build as _build

__all__ = ["build", "rwkv6_scan_cuda", "scratch_floats", "CHUNK", "SOURCE"]

SOURCE = _build.CSRC / "rwkv6_scan.cu"
CHUNK = 16              # the kernel's chunk length (Q in the source)


def scratch_floats(b: int, s: int, h: int, head_size: int = 64) -> int:
    """Float32 elements of the scratch the kernel's passes share: each
    chunk's local state [K,K] (then the state entering it) and its summed
    log-decay [K]."""
    n_chunks = -(-s // CHUNK)
    return b * h * n_chunks * (head_size * head_size + head_size)


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [p, p, p, p, p, i, p, p, p,
                                      ctypes.c_longlong, i, i, i, i, p]
    lib.rwkv6_scan_launch.restype = i
    lib.rwkv6_scan_error_string.argtypes = [i]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, y: torch.Tensor,
                    state_out: torch.Tensor, scratch: torch.Tensor) -> None:
    """Launch the kernel's three passes on the current stream, writing
    ``y`` and ``state_out`` (float32) and using ``scratch`` (float32, at
    least ``scratch_floats`` elements).  r, k, v and u share one dtype,
    float32 or bfloat16, and w is float32; every tensor is contiguous on
    one card, r, k, v and w on 16-byte boundaries; the caller has checked
    shapes and dtypes (``ops.rwkv6_scan``)."""
    b, s, h, kk = r.shape
    if scratch.dtype != torch.float32 \
            or scratch.numel() < scratch_floats(b, s, h, kk):
        raise ValueError(f"rwkv6_scan: scratch must hold "
                         f"{scratch_floats(b, s, h, kk)} float32")
    lib = _build.load(SOURCE, _declare)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), int(r.dtype == torch.bfloat16), y.data_ptr(),
            state_out.data_ptr(), scratch.data_ptr(), scratch.numel(), b, s,
            h, kk, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: "
                           f"{lib.rwkv6_scan_error_string(err).decode()}")
