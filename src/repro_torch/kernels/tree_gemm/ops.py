"""Wrapper for the tree-GEMM kernel, consuming ``EnsembleGemm`` artifacts.

A CUDA tensor launches the hand-written kernel (``tree_gemm.py``) or
raises; a CPU tensor takes the plain version (``ref.py``) — the counterpart
of the JAX package running its Pallas kernel with ``interpret=True``.
There is no fallback from one to the other.  ``launches`` counts kernel
launches (and nothing else), so a run can show that it went through the
kernel.

The kernel runs ``gates . c`` on the int8 tensor cores and gates by a
gather of x at each node's feature, so it takes its own operands, derived
from the ensemble once and kept with it (``kernel_operands``).

A ``meta`` tensor is evaluated abstractly: the call returns empty outputs
of the right shapes and dtypes and reports its analytic work to
``kernels.cost`` (the dry-run's cost counter); any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ml.hummingbird import DeviceEnsemble, EnsembleGemm
from ...ml.tree import reciprocal_f32
from .. import cost
from .ref import tree_gemm_ref

__all__ = ["tree_gemm", "launches", "kernel_operands", "KernelOperands",
           "NO_LEAF", "MAX_NODES"]

launches = 0

_FMAX = float(np.finfo(np.float32).max)
NO_LEAF = 2**31 - 1        # d of a padded leaf: no sum of gates . c reaches it
_PAD_NODES, _PAD_LEAVES = 128, 64   # the kernel's tiles of I and of L
MAX_NODES = 512            # padded internal nodes the kernel is built for


class KernelOperands(NamedTuple):
    """The CUDA kernel's view of a ``DeviceEnsemble``, I padded to Ip (a
    multiple of 128) and L to Lp (a multiple of 64): padded nodes have
    feature 0, threshold fmax and zero rows of c; padded leaves zero
    columns of c and d = ``NO_LEAF``."""

    ct: torch.Tensor    # [T, Lp, Ip] int8: c transposed (K-major)
    d: torch.Tensor     # [T, Lp] int32
    feat: torch.Tensor  # [T, Ip] int32
    b: torch.Tensor     # [T, Ip] float32


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def kernel_operands(ens: DeviceEnsemble) -> KernelOperands:
    """Build the kernel's operands on the ensemble's device (once: they are
    kept in ``ens.kernel_operands``).  Raises if the ensemble has no
    feature indices, more than ``MAX_NODES`` internal nodes a tree, or if c
    or d do not have the values that make the int8 product exact: c in
    {-1, 0, +1}, d an integer in [0, I] or fmax."""
    cached = ens.kernel_operands.get("tree_gemm")
    if cached is not None:
        return cached
    if ens.feat is None:
        raise ValueError("tree_gemm: the ensemble carries no feature indices "
                         "(feat); the kernel gates by gathering x at them")
    t, n_f, i = ens.a.shape
    l = ens.c.shape[2]
    c, d, feat = ens.c, ens.d, ens.feat
    if tuple(feat.shape) != (t, i):
        raise ValueError(f"tree_gemm: feat has shape {tuple(feat.shape)}, "
                         f"expected {(t, i)}")
    if not bool(((c == 0) | (c == 1) | (c == -1)).all()):
        raise ValueError("tree_gemm: c holds values outside {-1, 0, +1}")
    sentinel = d == _FMAX
    if not bool((sentinel | ((d == torch.round(d)) & (d >= 0) & (d <= i)))
                .all()):
        raise ValueError(f"tree_gemm: d holds a value that is neither an "
                         f"integer in [0, {i}] nor the fmax sentinel")
    if not bool(((feat >= 0) & (feat < n_f)).all()):
        raise ValueError(f"tree_gemm: feat holds an index outside "
                         f"[0, {n_f})")
    ip, lp = _round_up(i, _PAD_NODES), _round_up(l, _PAD_LEAVES)
    if ip > MAX_NODES:
        raise ValueError(f"tree_gemm: {i} internal nodes a tree; the kernel "
                         f"takes up to {MAX_NODES} (trees of depth <= 9)")
    dev = c.device
    ct = torch.zeros((t, lp, ip), dtype=torch.int8, device=dev)
    ct[:, :l, :i] = c.transpose(1, 2).to(torch.int8)
    d32 = torch.full((t, lp), NO_LEAF, dtype=torch.int32, device=dev)
    d32[:, :l] = torch.where(sentinel, 0.0, d).to(torch.int32) \
        .masked_fill_(sentinel, NO_LEAF)
    feat32 = torch.zeros((t, ip), dtype=torch.int32, device=dev)
    feat32[:, :i] = feat.to(torch.int32)
    b = torch.full((t, ip), _FMAX, dtype=torch.float32, device=dev)
    b[:, :i] = ens.b
    ops = KernelOperands(ct, d32, feat32, b)
    ens.kernel_operands["tree_gemm"] = ops
    return ops


def _check(x: torch.Tensor, ens: DeviceEnsemble) -> None:
    arrays = {"a": ens.a, "b": ens.b, "c": ens.c, "d": ens.d, "e": ens.e}
    for name, arr in arrays.items():
        if arr.device != x.device:
            raise ValueError(f"tree_gemm: {name} on {arr.device}, x on "
                             f"{x.device}")
        if arr.dtype != torch.float32:
            raise TypeError(f"tree_gemm: {name} is {arr.dtype}, not float32")
        if not arr.is_contiguous():
            raise ValueError(f"tree_gemm: {name} is not contiguous")
    if x.dim() != 2:
        raise ValueError(f"tree_gemm: x must be [N, F], got {tuple(x.shape)}")
    n, f = x.shape
    t, fa, i = ens.a.shape
    l, o = ens.c.shape[2], ens.e.shape[2]
    want = {"a": (t, f, i), "b": (t, i), "c": (t, i, l), "d": (t, l),
            "e": (t, l, o)}
    for name, shape in want.items():
        if tuple(arrays[name].shape) != shape:
            raise ValueError(f"tree_gemm: {name} has shape "
                             f"{tuple(arrays[name].shape)}, expected {shape} "
                             f"for x [{n}, {f}]")
    if min(t, i, l, o) < 1:
        raise ValueError(f"tree_gemm: empty ensemble (T, I, L, O) = "
                         f"{(t, i, l, o)}")


def tree_gemm(ensemble, x: torch.Tensor) -> torch.Tensor:
    """Score an ``EnsembleGemm`` (or its ``DeviceEnsemble``) on ``x [N, F]``
    -> ``[N, O]``, averaged over trees when the ensemble says so."""
    global launches
    ens = ensemble.to_device(x.device) \
        if isinstance(ensemble, EnsembleGemm) else ensemble
    x = x.to(torch.float32)
    # The plain version gates via x . a, where NaN/±inf would poison every
    # gate column through 0 * NaN = NaN.  Mapping NaN/+inf -> fmax and -inf
    # -> -fmax keeps the gate booleans identical to traversal's per-node
    # comparisons: every real threshold is a finite data midpoint, so
    # fmax <= t is False (like NaN <= t and inf <= t) and -fmax <= t is
    # True (like -inf <= t).  The kernel's gather sees the same values.
    x = torch.nan_to_num(x, nan=_FMAX, posinf=_FMAX,
                        neginf=-_FMAX).contiguous()
    _check(x, ens)
    if x.device.type == "cpu":
        out = tree_gemm_ref(x, ens.a, ens.b, ens.c, ens.d, ens.e)
    elif x.device.type == "cuda":
        from .tree_gemm import tree_gemm_cuda
        operands = kernel_operands(ens)
        out = torch.empty((x.shape[0], ens.e.shape[2]), dtype=torch.float32,
                          device=x.device)
        tree_gemm_cuda(x, operands, ens.e, out)
        launches += 1
    elif x.device.type == "meta":
        out = torch.empty((x.shape[0], ens.e.shape[2]), dtype=torch.float32,
                          device="meta")
        work = cost.tree_gemm_cost(*x.shape, ens.a.shape[0], ens.a.shape[2],
                                   ens.c.shape[2], ens.e.shape[2])
        cost.report("tree_gemm", work["ops"], work["bytes"])
    else:
        raise ValueError(f"tree_gemm: no kernel for device {x.device}")
    # The JAX wrapper divides by n_trees under jit, which XLA turns into a
    # multiply by the float32 reciprocal; so does this.
    return out * reciprocal_f32(ens.n_trees) if ens.average else out
