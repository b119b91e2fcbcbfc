"""The port's speculative decoding (``serve/speculative.py``) on the CPU:
the twins of ``tests/test_speculative.py``'s three tests on
``reduced_config(qwen2.5-14b)`` with ``d_head`` 64 (the attention kernels'
widths), and the port's ``greedy_decode`` against the JAX package's on
the same parameters (carried across with ``models.convert``): along the
JAX continuation, the port's greedy token equals JAX's at every step whose
JAX top-1 margin exceeds twice ``_REL`` (5%) of the largest logit, and the
two continuations part, if at all, at a step whose margin does not (a near
tie may flip either way)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve.speculative import _full_forward_logits as jax_forward
from repro.serve.speculative import greedy_decode as jax_greedy_decode
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import SpecStats, greedy_decode, speculative_decode
from repro_torch.serve.speculative import _full_forward_logits as \
    port_forward

_REL = 0.05


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(reduced_config(get_config("qwen2.5-14b")),
                              d_head=64)
    target = build_model(cfg, device="cpu")
    t_params = target.init_params(torch.Generator().manual_seed(0))
    # draft: different (worse) weights, same family
    d_params = target.init_params(torch.Generator().manual_seed(99))
    return cfg, target, t_params, d_params


def test_speculative_equals_greedy(models):
    cfg, model, t_params, d_params = models
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    ref = greedy_decode(model, t_params, prompt, 10)
    out, stats = speculative_decode(model, t_params, model, d_params,
                                    prompt, 10, k=3)
    assert out == ref          # equal to target greedy, token for token
    assert isinstance(stats, SpecStats) and stats.proposed > 0


def test_self_draft_accepts_most(models):
    """Draft == target: acceptance near 1 (the draft runs the incremental
    bf16-KV path, the verifier the full forward; ulp-level argmax ties can
    cost an occasional rejection — correctness is unaffected)."""
    cfg, model, t_params, _ = models
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    out, stats = speculative_decode(model, t_params, model, t_params,
                                    prompt, 8, k=4)
    assert stats.acceptance_rate >= 0.5
    assert out == greedy_decode(model, t_params, prompt, 8)


def test_fewer_target_calls_than_tokens(models):
    cfg, model, t_params, _ = models
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    n = 12
    out, stats = speculative_decode(model, t_params, model, t_params,
                                    prompt, n, k=4)
    # even with imperfect acceptance, verify calls < tokens generated
    assert stats.target_calls < n and len(out) == n


def test_greedy_decode_matches_jax():
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(
        "qwen2.5-14b")), d_head=64)
    cfg = dataclasses.replace(reduced_config(get_config("qwen2.5-14b")),
                              d_head=64)
    jmodel = jax_build_model(jcfg, remat=False)
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(4)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(cfg, device="cpu")
    params = lm_params_from_numpy(cfg, np_params, device="cpu")
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, 7) \
        .astype(np.int32)
    n = 10
    want = jax_greedy_decode(jmodel, jparams, prompt, n)
    got = greedy_decode(model, params, prompt, n)
    # the margins and the port's tokens along JAX's own continuation
    seq = np.concatenate([prompt, np.asarray(want, np.int32)])
    rows = slice(len(prompt) - 1, len(prompt) - 1 + n)
    jl = np.asarray(jax_forward(jmodel, jparams, seq),
                    np.float32)[rows, :cfg.vocab_size]
    tl = port_forward(model, params, seq).numpy()[rows, :cfg.vocab_size]
    top2 = np.sort(jl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * _REL * np.abs(jl).max(-1)
    assert clear.any()
    np.testing.assert_array_equal(tl.argmax(-1)[clear], jl.argmax(-1)[clear])
    parted = [i for i in range(n) if got[i] != want[i]]
    if parted:
        assert not clear[parted[0]], f"parted at a clear step {parted[0]}"
