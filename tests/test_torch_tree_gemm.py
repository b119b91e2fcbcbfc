"""The port's tree-GEMM kernel module against the JAX package's.

The same forests (fitted by the JAX package, carried across as numpy
state) and the same inputs (numpy, from a seed, with NaN and ±inf) go
through:

- the JAX wrapper ``tree_gemm(..., interpret=True)`` and the port's wrapper
  on CPU tensors (its plain version) — **bitwise**, as the reference pins
  the kernel bitwise against traversal;
- the JAX ``tree_gemm_ref`` and the port's ``tree_gemm_ref`` on the same
  fmax-mapped inputs — within atol 1e-5, the JAX package's own tolerance
  for its ref (``tests/test_kernels.py``): the JAX ref contracts trees and
  leaves in one einsum, in XLA's order, while the port's plain version sums
  trees in tree order like the kernel, so they can differ in the last ulp;
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py``, which imports no JAX so that it runs
where the card is.

The grid is ``tests/test_tree_strategies.py``'s, plus one tree and ragged
row counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.tree_gemm import ops as jax_tg
from repro.kernels.tree_gemm.ref import tree_gemm_ref as jax_ref
from repro.ml import RandomForest as JaxForest
from repro.ml.hummingbird import ensemble_to_gemm_mxu as jax_ens128
from repro_torch.kernels.tree_gemm import ops as tg_ops
from repro_torch.kernels.tree_gemm.ref import tree_gemm_ref
from repro_torch.ml.convert import model_from_state, model_state
from repro_torch.ml.hummingbird import ensemble_to_gemm

_FMAX = float(np.finfo(np.float32).max)


def _forest_and_x(seed, n_trees, depth, n_features, n_rows, dtype_kind,
                  nan_frac):
    rng = np.random.default_rng(seed)
    if dtype_kind == "int":
        xf = rng.integers(-8, 8, size=(256, n_features)).astype(np.float32)
    else:
        xf = rng.normal(size=(256, n_features)).astype(np.float32)
    y = (xf[:, 0] > xf[:, -1]).astype(np.int32)
    rf = JaxForest(n_trees=n_trees, max_depth=depth, min_leaf=2,
                   seed=seed).fit(xf, y)
    if dtype_kind == "int":
        x = rng.integers(-10, 10, size=(n_rows, n_features)) \
            .astype(np.float32)
    else:
        x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    if nan_frac:
        mask = rng.random(x.shape) < nan_frac
        x[mask] = np.nan
        x[rng.random(x.shape) < nan_frac / 2] = np.inf
        x[rng.random(x.shape) < nan_frac / 2] = -np.inf
    return rf, x


_GRID = [  # (seed, n_trees, depth, n_features, dtype_kind, nan_frac, n_rows)
    (0, 1, 2, 2, "float", 0.0, 48),
    (1, 6, 6, 9, "float", 0.0, 48),
    (2, 4, 5, 5, "float", 0.05, 48),
    (3, 3, 4, 3, "float", 0.25, 48),
    (4, 5, 6, 7, "int", 0.0, 48),
    (5, 2, 3, 4, "int", 0.05, 48),
    (6, 6, 4, 8, "int", 0.25, 48),
    (7, 1, 6, 6, "float", 0.25, 48),
    (8, 1, 5, 4, "float", 0.1, 1),        # one tree, one row
    (9, 3, 5, 6, "float", 0.1, 129),      # ragged past one 128-row block
]


def _pair(case, pad=128):
    seed, n_trees, depth, n_features, dtype_kind, nan_frac, n_rows = case
    rf, x = _forest_and_x(seed, n_trees, depth, n_features, n_rows,
                          dtype_kind, nan_frac)
    port = model_from_state(model_state(rf))
    return jax_ens128(rf.trees), ensemble_to_gemm(port.trees, pad_to=pad), x


@pytest.mark.parametrize("case", _GRID, ids=lambda c: f"seed{c[0]}")
def test_plain_tree_gemm_matches_jax_interpret_bitwise(case):
    jens, tens, x = _pair(case)
    want = np.asarray(jax_tg.tree_gemm(jens, jnp.asarray(x), interpret=True))
    got = tg_ops.tree_gemm(tens, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", _GRID, ids=lambda c: f"seed{c[0]}")
def test_tree_gemm_ref_matches_jax_ref(case):
    jens, tens, x = _pair(case)
    xm = np.nan_to_num(x, nan=_FMAX, posinf=_FMAX, neginf=-_FMAX)
    want = np.asarray(jax.jit(jax_ref)(
        jnp.asarray(xm), *(jnp.asarray(getattr(jens, k)) for k in "abcde")))
    got = tree_gemm_ref(torch.from_numpy(xm),
                        *(torch.from_numpy(getattr(tens, k)) for k in "abcde"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cpu_path_never_counts_a_launch():
    jens, tens, x = _pair(_GRID[2])
    before = tg_ops.launches
    tg_ops.tree_gemm(tens, torch.from_numpy(x))
    assert tg_ops.launches == before


def test_wrapper_rejects_mismatched_shapes():
    _, tens, x = _pair(_GRID[1])
    with pytest.raises(ValueError, match="expected"):
        tg_ops.tree_gemm(tens, torch.from_numpy(x[:, :-1]))
