"""Bind the hand-written CUDA decode-attention kernel
(``repro_torch/csrc/decode_attention.cu``, which replaces the TPU kernel
``decode_attention_pallas``).  ``kernels/build.py`` compiles it at first use;
nothing here runs at import time."""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from .. import build as _build

__all__ = ["build", "decode_attention_cuda", "split_layout",
           "scratch_floats", "SOURCE"]

SOURCE = _build.CSRC / "decode_attention.cu"
SPLIT_STEP = 64         # split lengths are multiples of this many slots
MAX_SPLIT = 512         # slots a split holds at most (kMaxSplit)
MAX_SPLITS = 32         # splits of a row the combine reads, while T <= 16K


def split_layout(t: int) -> Tuple[int, int]:
    """(n_splits, split_len) of a cache of ``t`` slots: splits of
    SPLIT_STEP slots, longer (in steps of SPLIT_STEP, up to MAX_SPLIT) where
    that would make more than MAX_SPLITS of them; the splits cover [0, t)
    and the last may be shorter.

    A function of the cache's length alone, never of the lengths in it: the
    wrapper reads no length on the host, a captured call replays with new
    lengths, and every batch row, KV head and query head is cut alike.
    Short splits give many blocks (a block per split, KV head, tile of
    query heads and batch row): 320 and 640 at Hymba-1.5B's ring and global
    caches (5 KV heads, B 4), where a longer split was slower on the card
    (``PERF.md``)."""
    split_len = _cdiv(_cdiv(t, MAX_SPLITS), SPLIT_STEP) * SPLIT_STEP
    split_len = min(max(split_len, SPLIT_STEP), MAX_SPLIT)
    return _cdiv(t, split_len), split_len


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def scratch_floats(b: int, h: int, d: int, t: int) -> int:
    """Float32 elements of the scratch the two kernels share for q
    [B,1,H,D] over a cache of ``t`` slots: each split's partial (m, l) and
    acc [D] per batch row and query head."""
    return b * h * split_layout(t)[0] * (d + 2)


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [p, p, p, p, p, p,
                                            ctypes.c_longlong, i, i, i, i, i,
                                            i, i, i, f, f, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_error_string.argtypes = [i]
    lib.decode_attention_error_string.restype = ctypes.c_char_p


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor,
                          out: torch.Tensor, softcap: float,
                          scratch: torch.Tensor) -> None:
    """Launch the split and combine kernels on the current stream, writing
    ``out`` (shaped and typed like ``q``) and using ``scratch`` (float32, at
    least ``scratch_floats`` elements), with the splits of
    ``split_layout``.  The caller has checked devices, dtypes, shapes,
    contiguity and alignment (``ops.decode_attention``)."""
    b, _, h, d = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    n_splits, split_len = split_layout(t)
    need = scratch_floats(b, h, d, t)
    if scratch.dtype != torch.float32 or scratch.numel() < need:
        raise ValueError(f"decode_attention: scratch must hold {need} "
                         f"float32")
    lib = _build.load(SOURCE, _declare)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), b, t, h, kv, d, int(q.dtype == torch.bfloat16),
            n_splits, split_len, 1.0 / math.sqrt(d), float(softcap), stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention launch failed: "
            f"{lib.decode_attention_error_string(err).decode()}")
