"""The expert-parallel MoE paths over a mesh of CPU devices against the
JAX package's exact oracle ``moe_reference`` (``test_moe_variants.py``'s
check: capacity factor 8, so nothing is dropped, atol 1e-4).

The port's meshes stand several cards by the CPU listed several times:
each model shard holds ``n_experts / n_model`` experts, the psum sums the
shards' float32 outputs in ascending shard order and the all-to-all
exchanges blocks by copies, so 1, 2 and 4 devices run the code paths a
multi-card mesh runs.  The JAX parameters and inputs (numpy, seeded) are
carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import moe as jax_moe
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe

_ATOL = 1e-4
_CF = 8.0


def _setup(arch, b=2, s=8, seed=1):
    jcfg = jax_reduced_config(jax_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jp = jax_init_params(jax_moe.moe_params(jcfg), jax.random.PRNGKey(0))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)
    ref = np.asarray(jax_moe.moe_reference(jcfg, jp, jnp.asarray(x)))
    return cfg, jcfg, jp, p, x, ref


_MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (2, 1)]


@pytest.mark.parametrize("data,model", _MESHES)
@pytest.mark.parametrize("path", ["psum", "a2a"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "granite-moe-1b-a400m"])
def test_sharded_paths_match_the_reference(arch, path, data, model):
    cfg, _, _, p, x, ref = _setup(arch)
    mesh = make_local_mesh(data, model, device=["cpu"] * (data * model))
    fn = moe.moe_apply_sharded if path == "psum" \
        else moe.moe_apply_sharded_a2a
    got = fn(cfg, p, torch.from_numpy(x), mesh, ("data",),
             capacity_factor=_CF)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=_ATOL)


@pytest.mark.parametrize("model", [1, 2, 4])
def test_one_token_takes_the_psum_path(model):
    """S = 1 (a decode step) does not split over the model shards: the
    all-to-all path is the psum path, bit for bit, as in the JAX package."""
    cfg, _, _, p, x, ref = _setup("qwen3-moe-30b-a3b", b=4, s=1, seed=2)
    mesh = make_local_mesh(1, model, device=["cpu"] * model)
    xt = torch.from_numpy(x)
    a2a = moe.moe_apply_sharded_a2a(cfg, p, xt, mesh, ("data",),
                                    capacity_factor=_CF)
    psum = moe.moe_apply_sharded(cfg, p, xt, mesh, ("data",),
                                 capacity_factor=_CF)
    assert torch.equal(a2a, psum)
    np.testing.assert_allclose(a2a.numpy(), ref, atol=_ATOL)


@pytest.mark.parametrize("path", ["psum", "a2a"])
def test_one_device_matches_the_jax_sharded_path(path):
    """On a one-device mesh the JAX package's ``shard_map`` paths run their
    full dispatch; the port's agree with them at the default capacity
    factor (1.25, tokens dropped alike: stable top-C in both)."""
    cfg, jcfg, jp, p, x, _ = _setup("qwen3-moe-30b-a3b")
    jfn = jax_moe.moe_apply_sharded if path == "psum" \
        else jax_moe.moe_apply_sharded_a2a
    want = np.asarray(jfn(jcfg, jp, jnp.asarray(x), jax_local_mesh(1, 1),
                          ("data",)))
    fn = moe.moe_apply_sharded if path == "psum" \
        else moe.moe_apply_sharded_a2a
    got = fn(cfg, p, torch.from_numpy(x),
             make_local_mesh(1, 1, device="cpu"), ("data",))
    np.testing.assert_allclose(got.numpy(), want, atol=_ATOL)


def test_sharded_paths_are_deterministic_and_refuse_bad_meshes():
    cfg, _, _, p, x, _ = _setup("qwen3-moe-30b-a3b")
    mesh = make_local_mesh(2, 2, device=["cpu"] * 4)
    xt = torch.from_numpy(x)
    for fn in (moe.moe_apply_sharded, moe.moe_apply_sharded_a2a):
        assert torch.equal(fn(cfg, p, xt, mesh, ("data",)),
                           fn(cfg, p, xt, mesh, ("data",)))
    three = make_local_mesh(1, 3, device=["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_apply_sharded(cfg, p, xt, three, ("data",))
    with pytest.raises(ValueError, match="batch"):
        moe.moe_apply_sharded(cfg, p, xt[:1], mesh, ("data",))
