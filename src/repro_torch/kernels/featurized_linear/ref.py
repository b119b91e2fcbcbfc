"""Plain torch version of the featurized-linear kernel: a table lookup for
each one-hot column and the scaler's arithmetic for each scaled one, folded
into the logit in the featurize node's column order, one float32 operation
at a time (the kernel's order; see ``csrc/featurized_linear.cu``).  CPU
tensors take this path; on the card it is the version the kernel is held
against, bitwise."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

__all__ = ["Block", "ONE_HOT", "SCALER", "featurized_linear_ref"]

ONE_HOT, SCALER = 0, 1


class Block(NamedTuple):
    """What one input column adds to the logit.  A one-hot column reads
    ``table[offset + code - base]`` for a code in ``[base, base + size)``
    and ``zero`` for any other; a scaled column adds
    ``((float(x) - mean) * inv_std) * weight``.  The floats are float32
    values."""

    column: str
    kind: int
    offset: int = 0
    base: int = 0
    size: int = 0
    zero: float = 0.0
    mean: float = 0.0
    inv_std: float = 0.0
    weight: float = 0.0


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _lookup(x: torch.Tensor, b: Block, table: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    lo, hi = b.base, b.base + b.size - 1
    inside = (x >= lo) & (x <= hi)
    code = x.masked_fill(~inside, lo)
    return torch.where(inside, table[code - lo + b.offset],
                       _f32(b.zero, x.device))


def featurized_linear_ref(columns: Sequence[torch.Tensor],
                          blocks: Sequence[Block], table: torch.Tensor,
                          bias: float) -> torch.Tensor:
    """``columns[j]`` is block j's column ([n] each: int32 or bool codes,
    float32 or int32 scaled values) -> logits [n, 1]."""
    dev = table.device
    acc = torch.full((columns[0].shape[0],), -0.0, dtype=torch.float32,
                     device=dev)
    for x, b in zip(columns, blocks):
        if b.kind == SCALER:
            term = ((x.to(torch.float32) - _f32(b.mean, dev))
                    * _f32(b.inv_std, dev)) * _f32(b.weight, dev)
        else:
            term = _lookup(x, b, table)
        acc = acc + term
    return (acc + _f32(bias, dev))[:, None]
