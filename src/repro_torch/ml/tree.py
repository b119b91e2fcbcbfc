"""Decision trees and ensembles: numpy CART training, torch inference.

The paper's running example and most of its optimizations (predicate-based
pruning, model inlining, NN translation) revolve around decision trees and
tree ensembles.  We implement:

- CART training (gini / mse) in numpy — models are *trained once, served many
  times*, exactly the paper's setting;
- array-form trees (`TreeArrays`) that serve as the single source of truth for
  every downstream representation: tensor traversal inference, SQL CASE-WHEN
  inlining (`repro_torch.core.rules.model_inlining`), Hummingbird GEMM
  translation (`repro_torch.ml.hummingbird`), and the CUDA `tree_gemm`
  kernel;
- constraint-based structural pruning — the engine behind the paper's
  "predicate-based model pruning" (§4.1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["TreeArrays", "DeviceTree", "DecisionTree", "RandomForest",
           "GradientBoostedTrees", "fit_tree_arrays", "traverse",
           "reciprocal_f32", "Scorer"]

Scorer = Callable[[torch.Tensor], torch.Tensor]


class DeviceTree(NamedTuple):
    """A :class:`TreeArrays` placed on one device (int64 indices, since
    torch gathers with them)."""

    feature: torch.Tensor
    threshold: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    value: torch.Tensor
    depth: int


def traverse(tree: DeviceTree, x: torch.Tensor) -> torch.Tensor:
    """Vectorized traversal: [n, n_features] -> [n, n_outputs].  Exactly
    ``depth`` gather steps (leaves self-loop), as in the reference."""
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    node = torch.zeros((n,), dtype=torch.int64, device=x.device)
    for _ in range(max(tree.depth, 1)):
        is_leaf = tree.left[node] < 0
        go_left = x[rows, tree.feature[node]] <= tree.threshold[node]
        nxt = torch.where(go_left, tree.left[node], tree.right[node])
        node = torch.where(is_leaf, node, nxt)
    return tree.value[node]


def reciprocal_f32(n: int) -> float:
    """float32(1/n).  The reference's plans run jitted, and XLA rewrites a
    division by the constant n into a multiplication by this reciprocal, so
    the port averages the same way to stay bitwise equal."""
    return float(np.float32(1.0) / np.float32(n))


@dataclasses.dataclass
class TreeArrays:
    """A binary decision tree in index-array form.

    node i: if ``x[feature[i]] <= threshold[i]`` go to ``left[i]`` else
    ``right[i]``.  Leaves have ``left == -1`` and carry ``value[i]``
    (shape [n_outputs]).  Depth is the max root-to-leaf length; tensor
    traversal runs exactly ``depth`` gather steps (leaves self-loop).
    """

    feature: np.ndarray      # int32  [n_nodes]
    threshold: np.ndarray    # float32[n_nodes]
    left: np.ndarray         # int32  [n_nodes]
    right: np.ndarray        # int32  [n_nodes]
    value: np.ndarray        # float32[n_nodes, n_outputs]
    depth: int
    n_features: int

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_outputs(self) -> int:
        return int(self.value.shape[1])

    def is_leaf(self) -> np.ndarray:
        return self.left < 0

    def leaf_indices(self) -> np.ndarray:
        return np.nonzero(self.is_leaf())[0]

    def used_features(self) -> np.ndarray:
        """Features actually referenced by internal nodes (post-pruning this
        shrinks — enabling model-projection pushdown)."""
        internal = ~self.is_leaf()
        return np.unique(self.feature[internal])

    # -- inference ---------------------------------------------------------
    def to_device(self, device) -> DeviceTree:
        def idx(a):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return DeviceTree(idx(self.feature),
                          torch.as_tensor(self.threshold, device=device),
                          idx(self.left), idx(self.right),
                          torch.as_tensor(self.value, device=device),
                          int(self.depth))

    def predict_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Vectorized traversal: [n, n_features] -> [n, n_outputs]."""
        return traverse(self.to_device(x.device), x)

    def predict_numpy(self, x: np.ndarray) -> np.ndarray:
        """Host oracle used by tests."""
        out = np.zeros((x.shape[0], self.n_outputs), np.float32)
        for i in range(x.shape[0]):
            node = 0
            while self.left[node] >= 0:
                node = (self.left[node]
                        if x[i, self.feature[node]] <= self.threshold[node]
                        else self.right[node])
            out[i] = self.value[node]
        return out

    # -- structural transforms ----------------------------------------------
    def prune_with_constraints(self, bounds: Dict[int, Tuple[float, float]]
                               ) -> "TreeArrays":
        """Prune branches unreachable given per-feature CLOSED [lo, hi] bounds.

        ``bounds[f] = (lo, hi)`` asserts lo <= x[f] <= hi for every row that
        can reach the model (derived from WHERE-clause constraints or table
        statistics).  A node testing ``x[f] <= t`` with hi <= t always goes
        left; with lo > t always goes right — both directions are *provably*
        sound for closed intervals.  Strict constraints (``x > v``) are
        encoded by callers as ``lo = nextafter(v, +inf)``.  Reachable nodes
        are re-packed into a new tree.  This is the paper's predicate-based
        model pruning (§4.1).
        """
        keep_root = self._resolve(0, dict(bounds))
        return _repack(self, keep_root)

    def _resolve(self, node: int, bounds: Dict[int, Tuple[float, float]]
                 ) -> "._PrunedNode":
        if self.left[node] < 0:
            return _PrunedNode(leaf_value=self.value[node])
        f = int(self.feature[node])
        t = float(self.threshold[node])
        lo, hi = bounds.get(f, (-np.inf, np.inf))
        if hi <= t:   # lo <= x <= hi <= t  => always left
            return self._resolve(int(self.left[node]), bounds)
        if lo > t:    # x >= lo > t         => always right
            return self._resolve(int(self.right[node]), bounds)
        lb = dict(bounds)
        lb[f] = (lo, min(hi, t))
        left = self._resolve(int(self.left[node]), lb)
        rb = dict(bounds)
        rb[f] = (max(lo, float(np.nextafter(t, np.inf))), hi)
        right = self._resolve(int(self.right[node]), rb)
        return _PrunedNode(feature=f, threshold=t, left=left, right=right)


@dataclasses.dataclass
class _PrunedNode:
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_PrunedNode"] = None
    right: Optional["_PrunedNode"] = None
    leaf_value: Optional[np.ndarray] = None

    @property
    def is_leaf(self):
        return self.leaf_value is not None


def _repack(src: TreeArrays, root: _PrunedNode) -> TreeArrays:
    feats: List[int] = []
    thrs: List[float] = []
    lefts: List[int] = []
    rights: List[int] = []
    vals: List[np.ndarray] = []

    def alloc(node: _PrunedNode) -> int:
        idx = len(feats)
        feats.append(node.feature)
        thrs.append(node.threshold)
        lefts.append(-1)
        rights.append(-1)
        vals.append(node.leaf_value if node.is_leaf
                    else np.zeros((src.n_outputs,), np.float32))
        if not node.is_leaf:
            lefts[idx] = alloc(node.left)
            rights[idx] = alloc(node.right)
        return idx

    alloc(root)

    def depth_of(i: int) -> int:
        if lefts[i] < 0:
            return 0
        return 1 + max(depth_of(lefts[i]), depth_of(rights[i]))

    return TreeArrays(
        feature=np.asarray(feats, np.int32),
        threshold=np.asarray(thrs, np.float32),
        left=np.asarray(lefts, np.int32),
        right=np.asarray(rights, np.int32),
        value=np.stack(vals).astype(np.float32),
        depth=depth_of(0),
        n_features=src.n_features,
    )


# ---------------------------------------------------------------------------
# CART training (numpy, vectorized split search)
# ---------------------------------------------------------------------------

def _best_split(x: np.ndarray, y: np.ndarray, task: str,
                min_leaf: int) -> Optional[Tuple[int, float, float]]:
    """Return (feature, threshold, gain) or None."""
    n, d = x.shape
    best: Optional[Tuple[int, float, float]] = None
    if task == "classification":
        n_classes = y.shape[1]
        parent = y.sum(0)
        parent_imp = 1.0 - ((parent / max(n, 1)) ** 2).sum()
    else:
        parent_imp = y.var() if n else 0.0
    for f in range(d):
        order = np.argsort(x[:, f], kind="stable")
        xs = x[order, f]
        ys = y[order]
        if task == "classification":
            pref = np.cumsum(ys, axis=0)          # [n, C]
            total = pref[-1]
            nl = np.arange(1, n)[:, None].astype(np.float64)
            nr = n - nl
            lsum = pref[:-1]
            rsum = total - lsum
            gini_l = 1.0 - ((lsum / nl) ** 2).sum(1)
            gini_r = 1.0 - ((rsum / nr) ** 2).sum(1)
            imp = (nl[:, 0] * gini_l + nr[:, 0] * gini_r) / n
        else:
            yv = ys[:, 0].astype(np.float64)
            pref = np.cumsum(yv)
            pref2 = np.cumsum(yv * yv)
            nl = np.arange(1, n).astype(np.float64)
            nr = n - nl
            lsum, l2 = pref[:-1], pref2[:-1]
            rsum, r2 = pref[-1] - lsum, pref2[-1] - l2
            var_l = l2 / nl - (lsum / nl) ** 2
            var_r = r2 / nr - (rsum / nr) ** 2
            imp = (nl * var_l + nr * var_r) / n
        # valid split positions: where x strictly increases & both sides >= min_leaf
        pos_ok = (xs[1:] > xs[:-1])
        k = np.arange(1, n)
        pos_ok &= (k >= min_leaf) & (n - k >= min_leaf)
        if not pos_ok.any():
            continue
        imp = np.where(pos_ok, imp, np.inf)
        j = int(np.argmin(imp))
        gain = parent_imp - imp[j]
        if gain > 1e-12 and (best is None or gain > best[2]):
            thr = float((xs[j] + xs[j + 1]) / 2.0)
            best = (f, thr, float(gain))
    return best


def fit_tree_arrays(x: np.ndarray, y: np.ndarray, task: str = "regression",
                    max_depth: int = 6, min_leaf: int = 5,
                    n_classes: Optional[int] = None,
                    feature_subsample: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> TreeArrays:
    """Greedy CART.  ``y``: [n] labels (classification) or [n] targets."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if task == "classification":
        n_classes = n_classes or int(y.max()) + 1
        onehot = np.zeros((n, n_classes), np.float64)
        onehot[np.arange(n), y.astype(int)] = 1.0
        ymat = onehot
    else:
        ymat = np.asarray(y, np.float64)[:, None]

    feats: List[int] = []
    thrs: List[float] = []
    lefts: List[int] = []
    rights: List[int] = []
    vals: List[np.ndarray] = []

    def leaf_value(idx: np.ndarray) -> np.ndarray:
        sub = ymat[idx]
        if task == "classification":
            probs = sub.sum(0) / max(len(idx), 1)
            return probs.astype(np.float32)
        return np.asarray([sub.mean() if len(idx) else 0.0], np.float32)

    def build(idx: np.ndarray, depth: int) -> int:
        node = len(feats)
        feats.append(-1)
        thrs.append(0.0)
        lefts.append(-1)
        rights.append(-1)
        vals.append(leaf_value(idx))
        if depth >= max_depth or len(idx) < 2 * min_leaf:
            return node
        cols = np.arange(d)
        if feature_subsample is not None and feature_subsample < d:
            cols = (rng or np.random.default_rng(0)).choice(
                d, feature_subsample, replace=False)
        sub_x = x[idx][:, cols]
        split = _best_split(sub_x, ymat[idx], task, min_leaf)
        if split is None:
            return node
        f_local, thr, _ = split
        f = int(cols[f_local])
        go_left = x[idx, f] <= thr
        feats[node] = f
        thrs[node] = thr
        lefts[node] = build(idx[go_left], depth + 1)
        rights[node] = build(idx[~go_left], depth + 1)
        return node

    build(np.arange(n), 0)

    def depth_of(i: int) -> int:
        if lefts[i] < 0:
            return 0
        return 1 + max(depth_of(lefts[i]), depth_of(rights[i]))

    return TreeArrays(
        feature=np.asarray(feats, np.int32),
        threshold=np.asarray(thrs, np.float32),
        left=np.asarray(lefts, np.int32),
        right=np.asarray(rights, np.int32),
        value=np.stack(vals).astype(np.float32),
        depth=depth_of(0),
        n_features=d,
    )


class DecisionTree:
    """sklearn-ish facade over :class:`TreeArrays`."""

    kind = "decision_tree"

    def __init__(self, task: str = "classification", max_depth: int = 6,
                 min_leaf: int = 5):
        self.task = task
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.tree: Optional[TreeArrays] = None
        self.feature_names: Optional[List[str]] = None

    def fit(self, x: np.ndarray, y: np.ndarray,
            feature_names: Optional[Sequence[str]] = None) -> "DecisionTree":
        self.tree = fit_tree_arrays(x, y, self.task, self.max_depth,
                                    self.min_leaf)
        self.feature_names = list(feature_names) if feature_names else None
        return self

    def scorer(self, device) -> Scorer:
        """Raw scores [n, n_outputs] with the tree placed on ``device``."""
        tree = self.tree.to_device(device)
        return lambda x: traverse(tree, x.to(torch.float32))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        scores = self.predict_scores(x)
        if self.task == "classification":
            return torch.argmax(scores, dim=-1).to(torch.int32)
        return scores[:, 0]

    def predict_scores(self, x: torch.Tensor) -> torch.Tensor:
        return self.scorer(x.device)(x)


class RandomForest:
    """Bagged CART ensemble (same technique covers tree ensembles in §4.2)."""

    kind = "random_forest"

    def __init__(self, n_trees: int = 10, task: str = "classification",
                 max_depth: int = 6, min_leaf: int = 5, seed: int = 0):
        self.n_trees = n_trees
        self.task = task
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.seed = seed
        self.trees: List[TreeArrays] = []
        self.feature_names: Optional[List[str]] = None

    def fit(self, x: np.ndarray, y: np.ndarray,
            feature_names: Optional[Sequence[str]] = None) -> "RandomForest":
        rng = np.random.default_rng(self.seed)
        n, d = x.shape
        self.trees = []
        for _ in range(self.n_trees):
            idx = rng.integers(0, n, size=n)
            self.trees.append(fit_tree_arrays(
                x[idx], y[idx], self.task, self.max_depth, self.min_leaf,
                feature_subsample=max(1, int(np.sqrt(d))), rng=rng))
        self.feature_names = list(feature_names) if feature_names else None
        return self

    def scorer(self, device) -> Scorer:
        """Mean of the trees' scores: summed left to right, averaged last."""
        trees = [t.to_device(device) for t in self.trees]
        inv = reciprocal_f32(len(trees))

        def score(x):
            x = x.to(torch.float32)
            acc = traverse(trees[0], x)
            for t in trees[1:]:
                acc = acc + traverse(t, x)
            return acc * inv
        return score

    def predict_scores(self, x: torch.Tensor) -> torch.Tensor:
        return self.scorer(x.device)(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        scores = self.predict_scores(x)
        if self.task == "classification":
            return torch.argmax(scores, dim=-1).to(torch.int32)
        return scores[:, 0]


class GradientBoostedTrees:
    """Squared-loss gradient boosting (regression / binary via logits)."""

    kind = "gbt"

    def __init__(self, n_trees: int = 20, max_depth: int = 4,
                 learning_rate: float = 0.2, min_leaf: int = 5):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.min_leaf = min_leaf
        self.trees: List[TreeArrays] = []
        self.base: float = 0.0
        self.feature_names: Optional[List[str]] = None

    def fit(self, x: np.ndarray, y: np.ndarray,
            feature_names: Optional[Sequence[str]] = None
            ) -> "GradientBoostedTrees":
        y = np.asarray(y, np.float64)
        self.base = float(y.mean())
        pred = np.full_like(y, self.base)
        self.trees = []
        for _ in range(self.n_trees):
            resid = y - pred
            t = fit_tree_arrays(x, resid, "regression", self.max_depth,
                                self.min_leaf)
            self.trees.append(t)
            pred = pred + self.learning_rate * t.predict_numpy(
                np.asarray(x, np.float32))[:, 0]
        self.feature_names = list(feature_names) if feature_names else None
        return self

    def scorer(self, device) -> Scorer:
        """Boosted sum [n] (not [n, 1]): base + lr * tree, tree by tree."""
        trees = [t.to_device(device) for t in self.trees]
        base, lr = self.base, self.learning_rate

        def score(x):
            x = x.to(torch.float32)
            out = torch.full((x.shape[0],), base, dtype=torch.float32,
                             device=x.device)
            for t in trees:
                # one fused multiply-add per tree, as XLA contracts the
                # reference's ``out + lr * tree`` under jit
                out = torch.add(out, traverse(t, x)[:, 0], alpha=lr)
            return out
        return score

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.scorer(x.device)(x)
