"""Wrapper for the featurized-linear kernel: a linear model's logit [n, 1]
from a row's raw input columns, for a ``featurize -> matmul_bias`` pair
that codegen's closure runs as one (``core/codegen.py``), so the feature
matrix is never made.

A CUDA tensor launches the hand-written kernel (``featurized_linear.py``)
or raises; a CPU tensor takes the plain version (``ref.py``).  There is no
fallback from one to the other.  ``launches`` counts kernel launches (and
nothing else), so a run can show that it went through the kernel.  A
``meta`` tensor is evaluated abstractly: the call returns an empty [n, 1]
and reports its analytic work to ``kernels.cost``; any other device
raises.

``fusable`` is the rule for which pairs the kernel takes: one-hot
featurizers over unique integer categories whose tables fit ``MAX_TABLE``
floats together, on int32 or bool code columns, and standard scalers of
float32 or int32 columns; at most ``MAX_BLOCKS`` columns; one output
column; finite weights.  ``prepare`` turns such a pair into the kernel's
operands, once per plan and device.  A column of another dtype at run
time raises, on every device.
"""

from __future__ import annotations

import ctypes
from typing import List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import cost
from .featurized_linear import DTYPES, CBlock, featurized_linear_cuda
from .ref import ONE_HOT, SCALER, Block, featurized_linear_ref

__all__ = ["featurized_linear", "fusable", "prepare", "kernel_blocks",
           "FeaturizedLinear", "launches", "MAX_BLOCKS", "MAX_TABLE",
           "TAKES"]

launches = 0

MAX_BLOCKS = 16          # input columns the kernel scores (kMaxBlocks)
MAX_TABLE = 1 << 16      # one-hot table entries, all columns together
# the column dtypes each kind of block takes (the port's 32-bit columns)
TAKES = {ONE_HOT: (torch.int32, torch.bool),
         SCALER: (torch.float32, torch.int32)}
_INT32 = np.iinfo(np.int32)


class FeaturizedLinear(NamedTuple):
    """The kernel's operands for one device: a descriptor a column, the
    one-hot tables, the bias (a float32 value); the columns' names, and the
    descriptors as the kernel takes them, pointers and dtypes unset."""

    blocks: Tuple[Block, ...]
    table: torch.Tensor
    bias: float
    columns: Tuple[str, ...]
    cblocks: ctypes.Array


def _blocks(featurizers: Sequence) -> List[tuple]:
    """(kind, column, what the block needs) per input column, in the
    featurize node's column order; raises ValueError where a featurizer is
    not one the kernel computes."""
    out = []
    for f in featurizers:
        kind = getattr(f, "kind", None)
        if kind == "one_hot":
            for c in f.columns:
                cats = np.asarray(f.categories[c])
                if cats.dtype.kind not in "iu":
                    raise ValueError(f"one-hot {c!r}: {cats.dtype} "
                                     f"categories")
                if cats.size and (np.unique(cats).size != cats.size
                                  or cats.min() < _INT32.min
                                  or cats.max() > _INT32.max):
                    raise ValueError(f"one-hot {c!r}: repeated or "
                                     f"out-of-range categories")
                out.append((ONE_HOT, c, cats.astype(np.int64)))
        elif kind == "scaler" and f.mean is not None and f.std is not None:
            inv_std = np.float32(1.0) / np.asarray(f.std, np.float32)
            for i, c in enumerate(f.columns):
                out.append((SCALER, c, (np.float32(f.mean[i]),
                                        np.float32(inv_std[i]))))
        else:
            raise ValueError(f"featurizer {kind!r}")
    return out


def fusable(featurizers: Sequence, weights, bias,
            dtypes: Mapping[str, torch.dtype]) -> bool:
    """Whether ``featurize(featurizers) -> matmul_bias(weights, bias)``
    over columns of ``dtypes`` (column -> dtype, as the plan shows them)
    runs as the kernel with the fold's bits (see the source's note)."""
    w = np.asarray(weights)
    if w.ndim != 2 or w.shape[1] != 1 or np.size(bias) != 1 \
            or not np.all(np.isfinite(w)):
        return False
    try:
        blocks = _blocks(featurizers)
    except ValueError:
        return False
    if any(dtypes.get(c) not in TAKES[k] for k, c, _ in blocks):
        return False
    width = sum(v.size if k == ONE_HOT else 1 for k, _, v in blocks)
    table = sum(int(v.max() - v.min()) + 1 for k, _, v in blocks
                if k == ONE_HOT and v.size)
    used = [b for b in blocks if b[0] == SCALER or b[2].size]
    return width == w.shape[0] and 1 <= len(used) <= MAX_BLOCKS \
        and table <= MAX_TABLE


def prepare(featurizers: Sequence, weights, bias, device) -> FeaturizedLinear:
    """The operands of a ``fusable`` pair on ``device``: a one-hot column
    with no category adds nothing and has no block; a kept category's
    entry is its weight, and every other entry the block's zero (-0 where
    every weight of the block has its sign bit set, else +0)."""
    w = np.asarray(weights, np.float32)[:, 0]
    blocks: List[Block] = []
    tables: List[np.ndarray] = []
    offset = feature = 0
    for kind, column, spec in _blocks(featurizers):
        if kind == SCALER:
            mean, inv_std = spec
            blocks.append(Block(column, SCALER, mean=float(mean),
                                inv_std=float(inv_std),
                                weight=float(w[feature])))
            feature += 1
            continue
        if not spec.size:
            continue
        wc = w[feature:feature + spec.size]
        feature += spec.size
        zero = np.float32(-0.0 if np.all(np.signbit(wc)) else 0.0)
        base = int(spec.min())
        table = np.full(int(spec.max()) - base + 1, zero, np.float32)
        table[spec - base] = np.where(wc != 0, wc, zero)
        blocks.append(Block(column, ONE_HOT, offset, base, table.size,
                            float(zero)))
        tables.append(table)
        offset += table.size
    flat = np.concatenate(tables) if tables else np.zeros(1, np.float32)
    cblocks = (CBlock * len(blocks))(*(
        CBlock(None, -1, b.kind, b.offset, b.base, b.size, b.zero, b.mean,
               b.inv_std, b.weight) for b in blocks))
    return FeaturizedLinear(
        tuple(blocks), torch.as_tensor(flat, device=device),
        float(np.asarray(bias, np.float32).reshape(-1)[0]),
        tuple(b.column for b in blocks), cblocks)


def kernel_blocks(op: FeaturizedLinear, columns: Sequence[torch.Tensor]
                  ) -> Tuple[ctypes.Array, bool, List[torch.Tensor]]:
    """The kernel's descriptors for ``columns`` (block j's column, [n]
    each, on the card, of a dtype its block takes): ``op``'s with each
    column's pointer and dtype set; whether every column is aligned for
    the kernel's vector loads; and the columns as the kernel reads them (a
    strided one copied), which the caller keeps alive until the launch is
    queued."""
    blocks = type(op.cblocks).from_buffer_copy(op.cblocks)
    aligned, read = True, []
    for b, x in zip(blocks, columns):
        code, align = DTYPES[x.dtype]
        if not x.is_contiguous():
            x = x.contiguous()
        b.col, b.dtype = x.data_ptr(), code
        aligned = aligned and b.col % align == 0
        read.append(x)
    return blocks, aligned, read


def featurized_linear(op: FeaturizedLinear,
                      columns: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Logits [n, 1] (float32) of the rows of ``columns`` (a table's
    columns, by name), from the operands ``prepare`` built."""
    global launches
    cols = [columns[c] for c in op.columns]
    n = cols[0].shape[0]
    dev = op.table.device
    for name, x, b in zip(op.columns, cols, op.blocks):
        if x.dtype not in TAKES[b.kind]:
            raise TypeError(f"featurized_linear: column {name!r} is "
                            f"{x.dtype}; its block takes "
                            f"{', '.join(map(str, TAKES[b.kind]))}")
        if x.dim() != 1 or x.shape[0] != n:
            raise ValueError(f"featurized_linear: column {name!r} has "
                             f"shape {tuple(x.shape)}, expected [{n}]")
        if x.device != dev:
            raise ValueError(f"featurized_linear: column {name!r} on "
                             f"{x.device}, operands on {dev}")
    if dev.type == "cpu":
        return featurized_linear_ref(cols, op.blocks, op.table, op.bias)
    if dev.type == "cuda":
        # cols now holds what the descriptors point at, alive past launch
        blocks, aligned, cols = kernel_blocks(op, cols)
        out = torch.empty((n, 1), dtype=torch.float32, device=dev)
        if n:
            featurized_linear_cuda(blocks, aligned, op.table, op.bias, out)
            launches += 1
        return out
    if dev.type == "meta":
        work = cost.featurized_linear_cost(
            n, sum(x.element_size() for x in cols),
            sum(b.kind == ONE_HOT for b in op.blocks),
            sum(b.kind == SCALER for b in op.blocks))
        cost.report("featurized_linear", work["ops"], work["bytes"])
        return torch.empty((n, 1), dtype=torch.float32, device=dev)
    raise ValueError(f"featurized_linear: no kernel for device {dev}")
