"""The port's mixture of experts (``models/moe.py``) against the JAX
package's, on the CPU.

- ``moe_apply`` and ``moe_reference`` on the same float32 parameters
  (``reduced_config`` of Qwen3-MoE and of Granite-MoE, the JAX package's
  init) and inputs, within 1e-5; ``moe_apply`` also on bfloat16 parameters
  and inputs (the model's layers), within a bfloat16 ulp of each output
  (XLA's softmax and torch's round a gate's last float32 bit apart).
- The twins of ``test_moe_capacity_matches_reference`` (generous capacity
  equals the exact mixture, 1e-4) and ``test_capacity_drops_lowest_gates``
  (capacity 1 stays finite and bounded).
- Ties: tokens with equal gates competing for an expert's capacity are
  kept lower index first, as ``jax.lax.top_k`` keeps them; the port agrees
  with JAX token for token where capacity binds on a crafted tie.
- Determinism: two runs are bitwise equal, and the combine sums each
  token's experts in ascending expert order (the JAX scatter's order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import moe as jax_moe
from repro.models.layers import init_params as jax_init_params
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe

_ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"]


def _setup(arch, seed=0, shape=(2, 8), **over):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               **over)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **over)
    np_p = jax.tree_util.tree_map(np.asarray, jax_init_params(
        jax_moe.moe_params(jcfg), jax.random.PRNGKey(seed)))
    x = np.array(0.5 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                           shape + (cfg.d_model,)))
    p = {k: torch.from_numpy(np.array(v)) for k, v in np_p.items()}
    return jcfg, cfg, np_p, p, x


@pytest.mark.parametrize("arch", _ARCHS)
@pytest.mark.parametrize("capacity_factor", [2.0, 0.5, 8.0])
def test_moe_apply_matches_jax(arch, capacity_factor):
    jcfg, cfg, np_p, p, x = _setup(arch)
    want = np.asarray(jax_moe.moe_apply(jcfg, np_p, jnp.asarray(x),
                                        capacity_factor=capacity_factor))
    got = moe.moe_apply(cfg, p, torch.from_numpy(x),
                        capacity_factor=capacity_factor)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_reference_matches_jax(arch):
    jcfg, cfg, np_p, p, x = _setup(arch)
    want = np.asarray(jax_moe.moe_reference(jcfg, np_p, jnp.asarray(x)))
    got = moe.moe_reference(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_apply_bfloat16_matches_jax(arch):
    """bfloat16 parameters and inputs, as the model's layers run it:
    the routing, the float32 expert products and the combine."""
    jcfg, cfg, np_p, p, x = _setup(arch, seed=3, shape=(4, 16))
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in np_p.items()}
    want = np.asarray(jax_moe.moe_apply(
        jcfg, jp, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = moe.moe_apply(cfg, {k: v.to(torch.bfloat16) for k, v in p.items()},
                        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                               atol=1e-6)


def test_moe_capacity_matches_reference():
    """With generous capacity the dispatch equals the exact mixture."""
    _, cfg, _, p, x = _setup("granite-moe-1b-a400m", seed=3)
    got = moe.moe_apply(cfg, p, torch.from_numpy(x), capacity_factor=8.0)
    ref = moe.moe_reference(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_capacity_drops_lowest_gates():
    """With capacity 1, each expert keeps only its highest-gate token —
    dropped tokens lose that expert's contribution but keep others."""
    _, cfg, _, p, x = _setup("qwen3-moe-30b-a3b")
    ref = moe.moe_reference(cfg, p, torch.from_numpy(x))
    counts = {}
    tight = moe.moe_apply(cfg, p, torch.from_numpy(x),
                          capacity_factor=0.01, counts=counts)
    t = tight.numpy()
    assert np.isfinite(t).all()
    assert np.abs(t).max() <= np.abs(ref.numpy()).max() * 5 + 1.0
    tokens = x.shape[0] * x.shape[1]
    assert int(counts["routed"]) == tokens * cfg.experts_per_token
    # each expert keeps at most one of its routed tokens
    assert int(counts["routed"]) - int(counts["dropped"]) <= cfg.n_experts


def test_capacity_tie_keeps_the_lower_token_as_jax():
    """Equal tokens get equal gates: with capacity binding, every expert
    keeps the lowest-index ones among them, in JAX and in the port."""
    jcfg, cfg, np_p, p, x = _setup("qwen3-moe-30b-a3b", seed=5,
                                   shape=(1, 8))
    x[0, 2:] = x[0, 1]                      # tokens 1..7 tie exactly
    gates = moe._route(cfg, torch.from_numpy(x[0]),
                       p["router"])
    assert bool((gates[1:] == gates[1]).all())
    cap = moe._capacity(cfg, 8, 0.5)
    assert cap < int((gates[:, gates[1].argmax()] > 0).sum())  # binds
    want = np.asarray(jax_moe.moe_apply(jcfg, np_p, jnp.asarray(x),
                                        capacity_factor=0.5))
    got = moe.moe_apply(cfg, p, torch.from_numpy(x),
                        capacity_factor=0.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the tied tokens kept are the first: token 1 gets its experts, the
    # last tied token loses the ones capacity binds on
    assert not np.allclose(got[0, 1], got[0, 7])
    np.testing.assert_array_equal(got[0, 1] == 0, want[0, 1] == 0)


def test_two_runs_are_bitwise_equal():
    _, cfg, _, p, x = _setup("granite-moe-1b-a400m", seed=7, shape=(4, 32))
    xs = torch.from_numpy(x)
    a = moe.moe_apply(cfg, p, xs, capacity_factor=1.0)
    b = moe.moe_apply(cfg, p, xs, capacity_factor=1.0)
    assert torch.equal(a, b)


def test_combine_sums_in_ascending_expert_order():
    """The combine equals a sequential float32 sum over each token's kept
    (expert, slot) outputs in ascending expert order, bitwise."""
    _, cfg, _, p, x = _setup("qwen3-moe-30b-a3b", seed=9, shape=(2, 16))
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    gates = moe._route(cfg, xf, p["router"])
    cap = moe._capacity(cfg, xf.shape[0], 1.0)
    got = moe._expert_compute(cfg, xf, gates, p["wi"], p["wg"], p["wo"],
                              cap)
    vals, tok = moe._top_k(gates.T, cap)                 # [E, C]
    xg = xf[tok.reshape(-1)].reshape(cfg.n_experts, cap, cfg.d_model)
    h = torch.bmm(xg, p["wi"])
    h = h * torch.nn.functional.silu(torch.bmm(xg, p["wg"]))
    y = torch.bmm(h, p["wo"]) * vals[..., None]
    want = torch.zeros_like(got)
    for e in range(cfg.n_experts):
        for c in range(cap):
            if vals[e, c] > 0:
                want[tok[e, c]] = want[tok[e, c]] + y[e, c]
    assert torch.equal(got, want)
    assert (vals == 0).any() and (vals > 0).any()
