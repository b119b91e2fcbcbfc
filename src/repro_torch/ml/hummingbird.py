"""NN translation: decision trees / ensembles -> GEMM pipelines.

The paper's "NN translation" (§4.2, Fig 2d) compiles classical ML operators to
tensor programs so a NN runtime executes them with hardware acceleration.  We
implement the GEMM strategy (as in Hummingbird, Nakandala et al.): a tree
becomes three matmuls plus comparisons —

    T = (X @ A  <= B)          gate each internal-node condition     [n, I]
    S = T @ C                  count satisfied path conditions       [n, L]
    leaf = argmax(S == D)      exactly-matching leaf                 [n]
    out  = onehot(leaf) @ E    leaf payout                           [n, O]

A [F, I] routes features to internal nodes, B [I] thresholds, C [I, L] is +1
where leaf l sits in the left subtree of node i (condition must hold), -1 for
the right subtree, 0 otherwise, D [L] = per-leaf count of +1 entries, and
E [L, O] holds leaf values.

The batched-ensemble form is also evaluated by the hand-written CUDA kernel
in ``repro_torch.kernels.tree_gemm`` (strategy ``"cuda"``); this module's
dense strategy leaves the products to ``torch.matmul``, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .tree import TreeArrays, reciprocal_f32

__all__ = ["TreeGemm", "EnsembleGemm", "DeviceEnsemble", "tree_to_gemm",
           "ensemble_to_gemm", "ensemble_to_gemm_mxu", "predict_gemm",
           "predict_ensemble_gemm"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class TreeGemm:
    """GEMM-form single tree.  Arrays are un-padded; padding happens at the
    ensemble/kernel layer."""

    a: np.ndarray  # [F, I] float32
    b: np.ndarray  # [I]
    c: np.ndarray  # [I, L]
    d: np.ndarray  # [L]
    e: np.ndarray  # [L, O]

    @property
    def n_features(self):
        return self.a.shape[0]


def tree_to_gemm(tree: TreeArrays) -> TreeGemm:
    internal = np.nonzero(~tree.is_leaf())[0]
    leaves = tree.leaf_indices()
    imap = {int(n): i for i, n in enumerate(internal)}
    lmap = {int(n): i for i, n in enumerate(leaves)}
    n_i = max(len(internal), 1)
    n_l = len(leaves)

    a = np.zeros((tree.n_features, n_i), np.float32)
    b = np.zeros((n_i,), np.float32)
    c = np.zeros((n_i, n_l), np.float32)
    d = np.zeros((n_l,), np.float32)
    e = np.zeros((n_l, tree.n_outputs), np.float32)

    for i, node in enumerate(internal):
        a[tree.feature[node], i] = 1.0
        b[i] = tree.threshold[node]

    # Path walk: for each leaf record the (node, direction) path from root.
    def walk(node: int, path: List[Tuple[int, bool]]):
        if tree.left[node] < 0:
            li = lmap[node]
            for anc, went_left in path:
                c[imap[anc], li] = 1.0 if went_left else -1.0
                if went_left:
                    d[li] += 1.0
            e[li] = tree.value[node]
            return
        walk(int(tree.left[node]), path + [(node, True)])
        walk(int(tree.right[node]), path + [(node, False)])

    walk(0, [])
    return TreeGemm(a, b, c, d, e)


def predict_gemm(g: TreeGemm, x: torch.Tensor) -> torch.Tensor:
    """Plain-torch oracle for the GEMM strategy."""
    def dev(a):
        return torch.as_tensor(a, device=x.device)
    t = (x @ dev(g.a) <= dev(g.b)).to(torch.float32)
    s = t @ dev(g.c)
    match = (s == dev(g.d)).to(torch.float32)
    # Exactly one leaf matches; argmax picks it.
    leaf = torch.argmax(match, dim=-1)
    return dev(g.e)[leaf]


@dataclasses.dataclass
class EnsembleGemm:
    """Padded, stacked GEMM-form ensemble: [n_trees, ...] batched matrices.

    Padding: I, L to multiples of ``pad_to`` (the CUDA kernel's strategy
    pads to 128); padded leaves get D = fmax sentinel (never matched),
    padded internal nodes get B = fmax (condition trivially true but C rows
    are zero so they never contribute).

    ``feat`` [T, I] carries each internal node's feature index (0 on padded
    nodes).  The dense strategy gates via a gather ``x[:, feat] <= b`` — same
    booleans as ``x @ a <= b`` for finite inputs, but NaN-exact vs traversal
    (``NaN <= t`` is False ⇒ go right, matching ``TreeArrays.predict_torch``)
    and free of the one-hot matmul that dominated the old lowering's FLOPs.
    """

    a: np.ndarray  # [T, F, I]
    b: np.ndarray  # [T, I]
    c: np.ndarray  # [T, I, L]
    d: np.ndarray  # [T, L]
    e: np.ndarray  # [T, L, O]
    n_trees: int
    average: bool = True
    feat: Optional[np.ndarray] = None  # [T, I] int32

    @property
    def n_features(self):
        return self.a.shape[1]

    def to_device(self, device) -> "DeviceEnsemble":
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)
        feat = dev(self.feat.astype(np.int64)) if self.feat is not None \
            else None
        return DeviceEnsemble(dev(self.a), dev(self.b), dev(self.c),
                              dev(self.d), dev(self.e), feat,
                              self.n_trees, self.average, {})


class DeviceEnsemble(NamedTuple):
    """An :class:`EnsembleGemm` placed on one device.

    ``kernel_operands`` holds what a kernel derives from the arrays at its
    first use and keeps for the ensemble's life (the CUDA tree GEMM's int8
    c and int32 d, ``kernels.tree_gemm.ops.kernel_operands``)."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    feat: Optional[torch.Tensor]
    n_trees: int
    average: bool
    kernel_operands: dict


def ensemble_to_gemm(trees: Sequence[TreeArrays], pad_to: int = 128,
                     average: bool = True) -> EnsembleGemm:
    gemms = [tree_to_gemm(t) for t in trees]
    n_f = gemms[0].a.shape[0]
    n_o = gemms[0].e.shape[1]
    max_i = _round_up(max(g.a.shape[1] for g in gemms), pad_to)
    max_l = _round_up(max(g.c.shape[1] for g in gemms), pad_to)
    T = len(gemms)
    a = np.zeros((T, n_f, max_i), np.float32)
    b = np.full((T, max_i), np.float32(np.finfo(np.float32).max))
    c = np.zeros((T, max_i, max_l), np.float32)
    d = np.full((T, max_l), np.float32(np.finfo(np.float32).max))
    e = np.zeros((T, max_l, n_o), np.float32)
    feat = np.zeros((T, max_i), np.int32)
    for t, g in enumerate(gemms):
        i, l = g.a.shape[1], g.c.shape[1]
        a[t, :, :i] = g.a
        b[t, :i] = g.b
        c[t, :i, :l] = g.c
        d[t, :l] = g.d
        e[t, :l] = g.e
        feat[t, :i] = np.argmax(g.a, axis=0).astype(np.int32)
    return EnsembleGemm(a, b, c, d, e, n_trees=T, average=average, feat=feat)


def ensemble_to_gemm_mxu(trees: Sequence[TreeArrays],
                         average: bool = True) -> EnsembleGemm:
    """The lowering the CUDA kernel's strategy uses: I and L padded to
    multiples of 128 (the name mirrors the JAX package)."""
    return ensemble_to_gemm(trees, pad_to=128, average=average)


def predict_ensemble_gemm(ens, x: torch.Tensor) -> torch.Tensor:
    """Dense GEMM strategy: [n, F] -> [n, O].  ``ens`` is an
    :class:`EnsembleGemm` or (inside a compiled plan) its
    :class:`DeviceEnsemble`.

    Bit-identical to forest traversal (``RandomForest.predict_scores``) by
    construction: gather-based gating reproduces each node comparison exactly
    (including NaN semantics); S = gates @ C sums only {-1, 0, +1} products so
    every partial sum is an exact small integer; match @ E adds the exact leaf
    value plus exact zeros; trees accumulate sequentially in tree order and
    average last — the same float32 operation sequence as traversal.  The
    products go to ``torch.matmul`` in full float32 (TF32 must stay off on
    the card: it would round the leaf values).
    """
    if isinstance(ens, EnsembleGemm):
        ens = ens.to_device(x.device)
    b, c, d, e = ens.b, ens.c, ens.d, ens.e
    if ens.feat is not None:
        feat = ens.feat

        def gate(t):
            return (x[:, feat[t]] <= b[t]).to(torch.float32)
    else:  # legacy ensembles without feature indices: one-hot matmul gating
        a = ens.a

        def gate(t):
            return (x @ a[t] <= b[t]).to(torch.float32)

    def one_tree(t):
        s = gate(t) @ c[t]                            # [n, L] exact ints
        match = (s == d[t]).to(torch.float32)
        return match @ e[t]                           # [n, O]

    acc = one_tree(0)
    for t in range(1, ens.n_trees):
        acc = acc + one_tree(t)
    return acc * reciprocal_f32(ens.n_trees) if ens.average else acc
