"""The port's hand-written CUDA kernels against their plain torch versions,
on the card.  A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips (inside a fixture) where no card is present.  The
file imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.tree_gemm import ops as tg_ops
from repro_torch.ml import RandomForest, ensemble_to_gemm

_GRID = [  # (seed, n_trees, depth, n_features, nan_frac, n_rows)
    (0, 1, 2, 2, 0.0, 48),
    (1, 6, 6, 9, 0.0, 48),
    (2, 4, 5, 5, 0.05, 129),
    (3, 3, 4, 3, 0.25, 1),
    (4, 12, 8, 7, 0.05, 5000),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _forest_and_x(seed, n_trees, depth, n_features, nan_frac, n_rows):
    rng = np.random.default_rng(seed)
    xf = rng.normal(size=(512, n_features)).astype(np.float32)
    y = (xf[:, 0] > xf[:, -1]).astype(np.int32)
    rf = RandomForest(n_trees=n_trees, max_depth=depth, min_leaf=2,
                      seed=seed).fit(xf, y)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    x[rng.random(x.shape) < nan_frac / 2] = np.inf
    x[rng.random(x.shape) < nan_frac / 2] = -np.inf
    return rf, x


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [128, 8])
@pytest.mark.parametrize("case", _GRID, ids=lambda c: f"seed{c[0]}")
def test_tree_gemm_kernel_matches_plain_bitwise(case, pad, cuda_device):
    """Bitwise against the plain version and traversal, NaN/±inf included;
    pad 8 gives I and L that are not multiples of the kernel's tiles."""
    rf, x = _forest_and_x(*case)
    ens = ensemble_to_gemm(rf.trees, pad_to=pad)
    xt = torch.from_numpy(x).to(cuda_device)
    before = tg_ops.launches
    got = tg_ops.tree_gemm(ens.to_device(cuda_device), xt)
    torch.cuda.synchronize()
    assert tg_ops.launches == before + 1
    want = tg_ops.tree_gemm(ens, torch.from_numpy(x))   # plain, on the CPU
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  rf.predict_scores(xt).cpu().numpy())


@pytest.mark.cuda
def test_tree_gemm_kernel_rejects_cpu_ensemble_on_cuda_x(cuda_device):
    rf, x = _forest_and_x(*_GRID[1])
    ens = ensemble_to_gemm(rf.trees, pad_to=128)
    with pytest.raises(ValueError, match="on cpu"):
        tg_ops.tree_gemm(ens.to_device("cpu"),
                         torch.from_numpy(x).to(cuda_device))
