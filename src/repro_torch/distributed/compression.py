"""Gradient compression: int8 quantization with error feedback (the JAX
package's ``distributed/compression.py``).

int8 with a per-tensor scale cuts a float32 gradient all-reduce 4x; error
feedback (Seide et al.; the 1-bit SGD lineage) keeps each step's
quantization residual and adds it back the next step, so the sum of what
was sent tracks the sum of the true gradients.  ``compress_tree`` models
the wire format as a ``make_train_step(compress_grads=...)`` hook: every
leaf quantized and dequantized.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..train.tree import leaves, tree_map, unflatten

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree",
           "make_error_feedback_compressor"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, float scale): scale = max|x| (at least 1e-12) / 127,
    values round(x / scale) (half to even) clipped to +-127."""
    absmax = x.abs().max()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads):
    """Quantize then dequantize every leaf (in float32, back in the leaf's
    dtype): the value an int8 all-reduce would contribute."""
    def one(g):
        q, s = quantize_int8(g.float())
        return dequantize_int8(q, s).to(g.dtype)
    return tree_map(one, grads)


def make_error_feedback_compressor() -> Callable:
    """Returns ``compress(grads, residual=None) -> (grads', residual')``:
    each leaf plus its carried residual is quantized; the new residual is
    what the quantization lost (float32, zeros at the start)."""

    def compress(grads, residual=None):
        if residual is None:
            residual = tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        sent, kept = [], []
        for g, r in zip(leaves(grads), leaves(residual)):
            total = g.float() + r
            deq = dequantize_int8(*quantize_int8(total))
            sent.append(deq.to(g.dtype))
            kept.append(total - deq)
        return unflatten(grads, sent), unflatten(grads, kept)

    return compress
