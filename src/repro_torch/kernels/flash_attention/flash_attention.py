"""Bind the hand-written CUDA flash-attention kernels
(``repro_torch/csrc/flash_attention.cu``, which replace the TPU kernel
``flash_attention_pallas``): bfloat16 inputs go to the ``wgmma`` + TMA
kernel, float32 inputs to the CUDA-core one.  ``kernels/build.py`` compiles
them at first use; nothing here runs at import time."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from .. import build as _build

__all__ = ["build", "flash_attention_cuda", "smem_bytes", "SOURCE"]

SOURCE = _build.CSRC / "flash_attention.cu"


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, f, i, i, f, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_smem_bytes.argtypes = [i, i]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block at head dim ``d``."""
    lib = _build.load(SOURCE, _declare)
    return lib.flash_attention_smem_bytes(d, int(dtype == torch.bfloat16))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool, window: int,
                         softcap: float,
                         lse: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on the current stream, writing ``out`` (shaped and
    typed like ``q``) and, where given, ``lse`` (float32 [B,H,S], contiguous:
    each row's log-sum-exp; None writes none).  The caller has checked
    devices, dtypes, shapes and contiguity (``ops.flash_attention``).  The bfloat16 kernel reads q, k
    and v through TMA tensor maps, whose base addresses must be 16-byte
    aligned (the row strides, H*D*2 and KV*D*2 bytes, are multiples of
    128 for every D taken)."""
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: the bfloat16 kernel loads q, k, "
                         "v by TMA, which needs 16-byte aligned bases")
    lib = _build.load(SOURCE, _declare)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, t, h, kv, d,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), int(causal),
            int(window), float(softcap), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
