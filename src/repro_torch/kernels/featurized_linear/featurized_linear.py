"""Bind the hand-written CUDA featurized-linear kernel
(``repro_torch/csrc/featurized_linear.cu``, which replaces no TPU kernel:
it fuses the one-hot featurizer and the scaler into a linear model's
row-wise fold).  ``kernels/build.py`` compiles it at first use; nothing here
runs at import time."""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import build as _build

__all__ = ["build", "featurized_linear_cuda", "CBlock", "SOURCE", "DTYPES"]

SOURCE = _build.CSRC / "featurized_linear.cu"
# column dtype -> the kernel's code for it, and the alignment in bytes that
# its four-row vector loads need
DTYPES = {torch.float32: (0, 16), torch.int32: (1, 16), torch.bool: (2, 4)}


class CBlock(ctypes.Structure):
    """The kernel's ``Block`` descriptor, field for field."""

    _fields_ = [("col", ctypes.c_void_p), ("dtype", ctypes.c_int),
                ("kind", ctypes.c_int), ("table_off", ctypes.c_int),
                ("base", ctypes.c_int), ("size", ctypes.c_int),
                ("zero", ctypes.c_float), ("mean", ctypes.c_float),
                ("inv_std", ctypes.c_float), ("weight", ctypes.c_float)]


def build() -> Path:
    """Compile the kernel (if this source has not been built yet) and
    return the library's path."""
    return _build.build(SOURCE)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.featurized_linear_launch.argtypes = [p, i, p, ctypes.c_float, p,
                                             ctypes.c_longlong, i, p]
    lib.featurized_linear_launch.restype = i
    lib.featurized_linear_block_bytes.argtypes = []
    lib.featurized_linear_block_bytes.restype = i
    lib.featurized_linear_error_string.argtypes = [i]
    lib.featurized_linear_error_string.restype = ctypes.c_char_p
    if lib.featurized_linear_block_bytes() != ctypes.sizeof(CBlock):
        raise RuntimeError("featurized_linear: the binding's Block does not "
                           "match the kernel's")


def featurized_linear_cuda(blocks: ctypes.Array, aligned: bool,
                           table: torch.Tensor, bias: float,
                           out: torch.Tensor) -> None:
    """Launch the kernel on the current stream: ``out [n, 1]`` (float32,
    contiguous) receives the logits of the rows of the columns that
    ``blocks`` point at (``ops.kernel_blocks``: contiguous [n] columns on
    the card, each of a dtype its block takes, ``ops.TAKES``; ``aligned``
    where each is
    aligned to four of its elements).  The caller has checked devices,
    dtypes and shapes (``ops.featurized_linear``)."""
    lib = _build.load(SOURCE, _declare)
    aligned = aligned and out.data_ptr() % 16 == 0
    card = out.get_device()
    with torch.cuda.device(card):
        stream = torch.cuda.current_stream(card).cuda_stream
        err = lib.featurized_linear_launch(
            ctypes.addressof(blocks), len(blocks), table.data_ptr(), bias,
            out.data_ptr(), out.shape[0], int(aligned), stream)
    if err != 0:
        msg = lib.featurized_linear_error_string(err).decode()
        raise RuntimeError(f"featurized_linear launch failed: {msg}")
