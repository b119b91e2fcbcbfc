"""The card's published peaks and each kernel's analytic work.

The kernel wrappers evaluate abstractly on ``meta`` tensors: they return
empty outputs of the right shapes and dtypes and report the work of the
call here, the operations and bytes the function needs (each input read
once, each output written once), the same counts ``chip_smoke.py``'s
bounds use.  ``launch.cost_analysis`` collects the reports while it counts
a program run on ``meta``; outside one, a report goes nowhere.  A CPU
tensor still takes the plain version and a CUDA tensor the kernel.

Peaks of one NVIDIA H100 SXM5 at its full 700 W (NVIDIA's data sheet,
dense, without sparsity), and its links.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List

import torch

__all__ = ["PEAK_FP32_FLOPS", "PEAK_BF16_FLOPS", "PEAK_INT8_OPS",
           "PEAK_BYTES_PER_S", "NVLINK_BYTES_PER_S",
           "INFINIBAND_BYTES_PER_S", "PEAKS", "report", "collecting",
           "flash_cost", "decode_cost", "wkv6_cost", "ssd_cost",
           "tree_gemm_cost", "featurized_linear_cost", "nbytes"]

PEAK_FP32_FLOPS = 67e12          # float32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12         # bfloat16 / float16 on the tensor cores
PEAK_INT8_OPS = 1979e12          # int8 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12       # HBM3
NVLINK_BYTES_PER_S = 450e9       # NVLink 4: 900 GB/s a card, each way half
INFINIBAND_BYTES_PER_S = 50e9    # one ConnectX-7 NDR port a card: 400 Gb/s
# operation class -> peak operations a second
PEAKS = {"fp32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_FLOPS,
         "int8": PEAK_INT8_OPS}

_sinks: List[Callable[[str, Dict[str, float], float], None]] = []


def report(kernel: str, ops: Dict[str, float], moved: float) -> None:
    """A kernel call's work: operations by class (keys of ``PEAKS``) and
    bytes moved, to every active collector."""
    for sink in _sinks:
        sink(kernel, ops, moved)


@contextlib.contextmanager
def collecting(sink: Callable[[str, Dict[str, float], float], None]
               ) -> Iterator[None]:
    """Send every ``report`` made inside the block to ``sink``."""
    _sinks.append(sink)
    try:
        yield
    finally:
        _sinks.remove(sink)


def nbytes(*tensors: torch.Tensor) -> float:
    return float(sum(math.prod(t.shape) * t.element_size()
                     for t in tensors))


def _op_class(dtype: torch.dtype) -> str:
    return "fp32" if dtype == torch.float32 else "bf16"


def flash_cost(q, k, v, causal: bool, window: int, lse: bool
               ) -> Dict[str, float]:
    """4 d flops per visible (query, key) pair (the last ``window`` keys,
    where > 0); q, k, v read once, out (and lse) written once."""
    b, s, h, d = q.shape
    t = k.shape[1]
    span = window if window > 0 else t
    if causal:     # sum over rows i of min(i + 1, span, t)
        cap = min(span, t)
        pairs = cap * (cap + 1) // 2 + max(s - cap, 0) * cap \
            if s >= cap else s * (s + 1) // 2
    else:
        pairs = s * t
    moved = 2 * nbytes(q) + nbytes(k, v) + (4.0 * b * h * s if lse else 0)
    return {"ops": {_op_class(q.dtype): 4.0 * d * pairs * b * h},
            "bytes": moved}


def decode_cost(q, k_cache, v_cache) -> Dict[str, float]:
    """4 d flops per (cache slot, query head); the caches, q, cache_len and
    out moved once.  The valid lengths are data the cost cannot read, so
    every slot counts as valid (a full cache)."""
    b, _, h, d = q.shape
    t = k_cache.shape[1]
    return {"ops": {_op_class(q.dtype): 4.0 * d * b * t * h},
            "bytes": nbytes(k_cache, v_cache) + 2 * nbytes(q) + 4.0 * b}


def wkv6_cost(r, k, v, w, u) -> Dict[str, float]:
    """The recurrence's 5 K^2 float32 flops a step and head; r, k, v, w, u
    read once, y and the final state written once (float32)."""
    b, s, h, kk = r.shape
    return {"ops": {"fp32": 5.0 * b * s * h * kk * kk},
            "bytes": nbytes(r, k, v, w, u)
            + 4.0 * (b * s * h * kk + b * h * kk * kk)}


def ssd_cost(x, dt, a, bmat, cmat) -> Dict[str, float]:
    """The recurrence's 5 P N float32 flops a step and head; x, dt, a, B, C
    read once, y and the final state written once (float32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    return {"ops": {"fp32": 5.0 * b * s * h * p * n},
            "bytes": nbytes(x, dt, a, bmat, cmat)
            + 4.0 * (b * s * h * p + b * h * p * n)}


def tree_gemm_cost(n: int, f: int, t: int, i: int, l: int, o: int
                   ) -> Dict[str, float]:
    """2 N T I L int8 tensor-core operations (S = gates . c) and N T (I + L)
    float32 gathers and compares; x read once, the operands (int8 c, int32
    d and feat, float32 b and e) once, the output written once."""
    return {"ops": {"int8": 2.0 * n * t * i * l,
                    "fp32": 1.0 * n * t * (i + l)},
            "bytes": 4.0 * n * f + t * i * l
            + 4.0 * t * (l + 2 * i + l * o) + 4.0 * n * o}


def featurized_linear_cost(n: int, row_bytes: int, n_one_hot: int,
                           n_scaler: int) -> Dict[str, float]:
    """A row's float32 operations: an add a one-hot column, a subtract, two
    multiplies and an add a scaled column, and the bias; the columns
    (``row_bytes`` a row) read once and the logit written once."""
    return {"ops": {"fp32": 1.0 * n * (n_one_hot + 4 * n_scaler + 1)},
            "bytes": 1.0 * n * (row_bytes + 4)}
