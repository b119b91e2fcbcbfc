"""Bind the hand-written CUDA decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``, which replaces the TPU kernel
``decode_attention_pallas``).  ``kernels/build.py`` compiles it at first use;
nothing here runs at import time."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import build as _build

__all__ = ["build", "decode_attention_cuda", "SOURCE"]

SOURCE = _build.CSRC / "decode_attention.cu"


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            f, f, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor,
                          out: torch.Tensor, softcap: float) -> None:
    """Launch the kernel on the current stream, writing ``out`` (shaped and
    typed like ``q``).  The caller has checked devices, dtypes, shapes,
    contiguity and alignment (``ops.decode_attention``)."""
    lib = _build.load(SOURCE, _declare)
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), b, t, h, kv, d,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
            float(softcap), stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention launch failed: "
            f"{lib.decode_attention_error_string(err).decode()}")
