"""The port's serving engine and sampling, on the CPU: ``tests/
test_serve_engine.py`` and the sampling tests of ``tests/
test_sampling_and_llm_query.py``, ported, plus the engine's greedy output
against the JAX engine's where the JAX model's top-1 margin is clear.

The model is ``reduced_config(qwen2.5-14b)`` with ``d_head`` 64 (the
attention kernels take head dims 64, 128 and 256), with the port's own
seeded parameters unless a test carries the JAX package's across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import (InferenceEngine, Request, ServeConfig,
                               restrict_vocab, sample_token)


@pytest.fixture(scope="module")
def tiny_lm():
    cfg = dataclasses.replace(reduced_config(get_config("qwen2.5-14b")),
                              d_head=64)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    return cfg, model, params


def _prompt(rng, cfg, n=8):
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def test_continuous_batching_completes_all(tiny_lm):
    cfg, model, params = tiny_lm
    eng = InferenceEngine(model, ServeConfig(n_slots=2, max_len=48,
                                             eos_token=-1))
    rng = np.random.default_rng(0)
    for i in range(5):
        eng.submit(Request(rid=i, prompt=_prompt(rng, cfg),
                           max_new_tokens=4))
    flash0, decode0 = flash_ops.launches, decode_ops.launches
    eng.run_until_drained(params)
    assert len(eng.completed) == 5
    assert all(len(r.output) == 4 for r in eng.completed)
    assert all(r.first_token_at is not None for r in eng.completed)
    assert eng.prefills == 5 and eng.decode_steps > 0
    # on the CPU the wrappers take their plain versions: no launches
    assert (flash_ops.launches, decode_ops.launches) == (flash0, decode0)


def test_greedy_decode_independent_of_batching(tiny_lm):
    """A request's greedy output must not depend on which other requests
    share the batch (slot isolation)."""
    cfg, model, params = tiny_lm
    rng = np.random.default_rng(1)
    p = _prompt(rng, cfg)

    def run(extra):
        eng = InferenceEngine(model, ServeConfig(n_slots=3, max_len=48,
                                                 eos_token=-1,
                                                 prefix_cache=False))
        eng.submit(Request(rid=0, prompt=p.copy(), max_new_tokens=5))
        for i, q in enumerate(extra):
            eng.submit(Request(rid=10 + i, prompt=q, max_new_tokens=5))
        eng.run_until_drained(params)
        return next(r.output for r in eng.completed if r.rid == 0)

    alone = run([])
    crowded = run([_prompt(rng, cfg), _prompt(rng, cfg)])
    assert alone == crowded


def test_prefix_cache_hit(tiny_lm):
    cfg, model, params = tiny_lm
    eng = InferenceEngine(model, ServeConfig(n_slots=2, max_len=48,
                                             eos_token=-1))
    rng = np.random.default_rng(2)
    p = _prompt(rng, cfg)
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=3))
    eng.run_until_drained(params)
    assert len(eng._prefix_cache) == 1
    eng.submit(Request(rid=1, prompt=p.copy(), max_new_tokens=3))
    eng.run_until_drained(params)
    assert len(eng._prefix_cache) == 1      # reused, not re-added
    assert eng.prefills == 1
    outs = {r.rid: r.output for r in eng.completed}
    assert outs[0] == outs[1]


def test_prefix_cache_survives_decoding(tiny_lm):
    """Decode writes the batch cache in place; the cached prefill must not
    see those writes."""
    cfg, model, params = tiny_lm
    eng = InferenceEngine(model, ServeConfig(n_slots=1, max_len=48,
                                             eos_token=-1))
    p = _prompt(np.random.default_rng(4), cfg)
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=6))
    eng.run_until_drained(params)
    _, pcache = eng._prefix_cache[p.tobytes()]
    assert int(pcache["len"][0]) == len(p)
    assert not pcache["layers"][0]["k"][:, len(p):].any()


def test_eos_stops_early(tiny_lm):
    cfg, model, params = tiny_lm
    rng = np.random.default_rng(3)
    p = _prompt(rng, cfg)
    probe = InferenceEngine(model, ServeConfig(n_slots=1, max_len=48,
                                               eos_token=-1))
    probe.submit(Request(rid=0, prompt=p, max_new_tokens=1))
    probe.run_until_drained(params)
    first = probe.completed[0].output[0]
    eng = InferenceEngine(model, ServeConfig(n_slots=1, max_len=48,
                                             eos_token=first))
    eng.submit(Request(rid=1, prompt=p.copy(), max_new_tokens=8))
    eng.run_until_drained(params)
    assert len(eng.completed[0].output) == 1


def test_max_len_stops_a_sequence(tiny_lm):
    cfg, model, params = tiny_lm
    eng = InferenceEngine(model, ServeConfig(n_slots=1, max_len=12,
                                             eos_token=-1))
    eng.submit(Request(rid=0, prompt=_prompt(np.random.default_rng(5), cfg),
                       max_new_tokens=50))
    eng.run_until_drained(params)
    assert len(eng.completed[0].output) == 12 - 1 - 8 + 1


def test_engine_vocab_restricted_request(tiny_lm):
    cfg, model, params = tiny_lm
    eng = InferenceEngine(model, ServeConfig(n_slots=1, max_len=32,
                                             eos_token=-1))
    allowed = (10, 11, 12)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=4, allowed_tokens=allowed))
    eng.submit(Request(rid=1, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=4, temperature=1.0,
                       allowed_tokens=allowed))
    eng.run_until_drained(params)
    for req in eng.completed:
        assert len(req.output) == 4
        assert set(req.output) <= set(allowed)


def test_greedy_engine_matches_jax_engine_where_clear():
    """Both engines serve the same requests on the same (JAX-initialized)
    weights.  Tokens are compared up to the first position where the JAX
    model's top-1 margin is within twice the cross-package logit tolerance
    of ``tests/test_torch_lm.py`` (a near tie may flip there, and every
    later token then follows another prefix)."""
    jcfg = dataclasses.replace(
        jax_reduced_config(jax_get_config("qwen2.5-14b")), d_head=64)
    cfg = dataclasses.replace(reduced_config(get_config("qwen2.5-14b")),
                              d_head=64)
    jmodel = jax_build_model(jcfg, remat=False)
    jparams = jmodel.init_params(jax.random.PRNGKey(7))
    params = lm_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [_prompt(rng, cfg, n) for n in (5, 9, 13)]
    jeng = JaxEngine(jmodel, JaxServeConfig(n_slots=2, max_len=32,
                                            eos_token=-1))
    eng = InferenceEngine(model, ServeConfig(n_slots=2, max_len=32,
                                             eos_token=-1))
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=4))
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=4))
    jeng.run_until_drained(jparams)
    eng.run_until_drained(params)
    jout = {r.rid: r.output for r in jeng.completed}
    out = {r.rid: r.output for r in eng.completed}
    compared = 0
    for i, p in enumerate(prompts):
        # replay the JAX request alone to read its margins
        logits, cache = jmodel.prefill(
            jparams, {"tokens": jnp.asarray(p)[None]}, max_len=32)
        for pos, tok in enumerate(jout[i]):
            row = np.asarray(logits, np.float32)[0, :cfg.vocab_size]
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= 2 * 0.05 * np.abs(row).max():
                break
            assert out[i][pos] == tok, (i, pos)
            compared += 1
            logits, cache = jmodel.decode_step(
                jparams, cache, jnp.asarray([[tok]], jnp.int32))
    assert compared > 0


# --------------------------------------------------------------- sampling

def test_restrict_vocab_masks():
    logits = torch.tensor([[1.0, 5.0, 3.0, 4.0]])
    tok = sample_token(logits, 0.0, None, allowed=(0, 2))
    assert int(tok[0]) == 2       # best allowed, not global argmax (1)
    assert restrict_vocab(logits, (1,))[0, 0] == float("-inf")


def test_restricted_sampling_never_leaves_set():
    gen = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 100)).astype(np.float32))
    allowed = (3, 7, 42)
    for _ in range(5):
        toks = sample_token(logits, 1.0, gen, allowed=allowed)
        assert toks.dtype == torch.int32
        assert set(toks.tolist()) <= set(allowed)


def test_sampling_follows_the_softmax():
    """Gumbel-max draws at temperature 2 and with top-k 2 land on each
    token about as often as softmax(logits / T) says."""
    gen = torch.Generator().manual_seed(1)
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4]])) * 2.0
    draws = torch.cat([sample_token(logits.expand(4000, 4), 2.0, gen)
                       for _ in range(5)])
    freq = torch.bincount(draws.long(), minlength=4).float() / draws.numel()
    assert torch.allclose(freq, torch.tensor([0.1, 0.2, 0.3, 0.4]),
                          atol=0.02)
    topk = sample_token(logits.expand(4000, 4), 2.0, gen, top_k=2)
    freq = torch.bincount(topk.long(), minlength=4).float() / topk.numel()
    assert freq[:2].sum() == 0
    assert abs(float(freq[3]) - 4 / 7) < 0.03
