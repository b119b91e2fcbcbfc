"""Wrapper for the tree-GEMM kernel, consuming ``EnsembleGemm`` artifacts.

A CUDA tensor launches the hand-written kernel (``tree_gemm.py``) or
raises; a CPU tensor takes the plain version (``ref.py``) — the counterpart
of the JAX package running its Pallas kernel with ``interpret=True``.
There is no fallback from one to the other.  ``launches`` counts kernel
launches (and nothing else), so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ml.hummingbird import DeviceEnsemble, EnsembleGemm
from ...ml.tree import reciprocal_f32
from .ref import tree_gemm_ref

__all__ = ["tree_gemm", "launches"]

launches = 0

_FMAX = float(np.finfo(np.float32).max)


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
    # The kernel gates via x . a, where NaN/±inf would poison every gate
    # column through 0 * NaN = NaN.  Mapping NaN/+inf -> fmax and -inf ->
    # -fmax keeps the gate booleans identical to traversal's per-node
    # comparisons: every real threshold is a finite data midpoint, so
    # fmax <= t is False (like NaN <= t and inf <= t) and -fmax <= t is
    # True (like -inf <= t).
    x = torch.nan_to_num(x, nan=_FMAX, posinf=_FMAX,
                        neginf=-_FMAX).contiguous()
    _check(x, ens)
    if x.device.type == "cpu":
        out = tree_gemm_ref(x, ens.a, ens.b, ens.c, ens.d, ens.e)
    elif x.device.type == "cuda":
        from .tree_gemm import tree_gemm_cuda
        out = torch.empty((x.shape[0], ens.e.shape[2]), dtype=torch.float32,
                          device=x.device)
        tree_gemm_cuda(x, ens.a, ens.b, ens.c, ens.d, ens.e, out)
        launches += 1
    else:
        raise ValueError(f"tree_gemm: no kernel for device {x.device}")
    # The JAX wrapper divides by n_trees under jit, which XLA turns into a
    # multiply by the float32 reciprocal; so does this.
    return out * reciprocal_f32(ens.n_trees) if ens.average else out
