"""Bind the hand-written CUDA flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``, which replaces the TPU kernel
``flash_attention_pallas``).  ``kernels/build.py`` compiles it at first use;
nothing here runs at import time."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import build as _build

__all__ = ["build", "flash_attention_cuda", "SOURCE"]

SOURCE = _build.CSRC / "flash_attention.cu"


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           f, i, i, f, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, causal: bool, window: int,
                         softcap: float) -> None:
    """Launch the kernel on the current stream, writing ``out`` (shaped and
    typed like ``q``).  The caller has checked devices, dtypes, shapes and
    contiguity (``ops.flash_attention``)."""
    lib = _build.load(SOURCE, _declare)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, kv, d, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(d), int(causal), int(window), float(softcap),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
