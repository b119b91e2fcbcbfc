"""The port's language model against the JAX package's, on the CPU.

``reduced_config`` of MiniCPM-2B (multi-head attention, embedding and logit
scales, depth-scaled residuals, tied head) and of Qwen2.5-14B (GQA with 2
query heads per KV head, QKV bias, untied head), each with ``d_head`` 64:
the attention kernels (on the TPU and on the card) take head dims 64, 128
and 256, and the port's wrappers refuse other widths on every device, so a
model that runs here also runs on the card.  The JAX package's parameters
(random QKV biases in place of its zero init, so that the bias path counts)
are carried across with ``models.convert``, and the same tokens go through
both packages:

- prefill logits, then 8 teacher-forced decode steps fed the same tokens,
  within ``_REL`` of the largest JAX logit: both packages round the
  bfloat16 head product to bfloat16 (an ulp is 0.8% of the top of the
  range) and bfloat16 activations through the blocks round at other places
  in XLA and in torch; the measured gap is under 2%;
- the greedy token agrees wherever the JAX top-1 margin exceeds twice that
  tolerance (elsewhere a near tie may flip either way).

Every test builds its own models; nothing sets global torch or JAX state.
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
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models import LanguageModel, build_model
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)

# "+softcap": MiniCPM with gemma2's attention and final-logit soft caps,
# which the dense path carries (the caps' kernels options and _logits).
_ARCHS = ["minicpm-2b", "qwen2.5-14b", "minicpm-2b+softcap"]
_BUILDABLE = set(list_archs())
_REL = 0.05
_DECODE_STEPS = 8


def _configs(arch):
    arch, _, variant = arch.partition("+")
    caps = {"attn_softcap": 50.0, "final_softcap": 30.0} \
        if variant == "softcap" else {}
    return (dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                d_head=64, **caps),
            dataclasses.replace(reduced_config(get_config(arch)), d_head=64,
                                **caps))


def _jax_params(jmodel, jcfg, seed):
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        for name in ("bq", "bk", "bv"):
            shape = params["layers"]["attn"][name].shape
            params["layers"]["attn"][name] = \
                (0.1 * rng.normal(size=shape)).astype(np.float32)
    return params


@pytest.fixture(scope="module", params=_ARCHS)
def pair(request):
    jcfg, cfg = _configs(request.param)
    jmodel = jax_build_model(jcfg, remat=False)
    np_params = _jax_params(jmodel, jcfg, seed=0)
    model = build_model(cfg, device="cpu")
    return (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
            cfg, model, lm_params_from_numpy(cfg, np_params, device="cpu"),
            np_params)


def _check_logits(cfg, jax_logits, port_logits, what):
    want = np.asarray(jax_logits, np.float32)[:, :cfg.vocab_size]
    got = port_logits.numpy()[:, :cfg.vocab_size]
    tol = _REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)
    # padded vocab positions are masked on both sides
    assert (port_logits.numpy()[:, cfg.vocab_size:] == -1e30).all()
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear], err_msg=what)
    return int(clear.sum())


def test_prefill_and_teacher_forced_decode_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params, _ = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                max_len=64)
    tl, cache = model.prefill(params, torch.from_numpy(toks), max_len=64)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_padded)
    compared = _check_logits(cfg, jl, tl, "prefill")
    assert cache["len"].tolist() == [37, 37]
    for step in range(_DECODE_STEPS):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        compared += _check_logits(cfg, jl, tl, f"decode step {step}")
    assert cache["len"].tolist() == [37 + _DECODE_STEPS] * 2
    assert compared > 0            # some greedy tokens were compared


def test_prefill_cache_matches_jax(pair):
    """The decode cache prefill hands over: bfloat16 k/v of the prompt,
    zero past it, at full capacity."""
    jcfg, jmodel, jparams, cfg, model, params, _ = pair
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 21)) \
        .astype(np.int32)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               max_len=32)
    _, cache = model.prefill(params, torch.from_numpy(toks), max_len=32)
    for jl, tl in zip(jcache["layers"], cache["layers"]):
        for name in ("k", "v"):
            assert tl[name].dtype == torch.bfloat16
            assert tuple(tl[name].shape) == jl[name].shape
            assert not tl[name][:, 21:].any()
            np.testing.assert_allclose(
                tl[name].float().numpy(), np.asarray(jl[name], np.float32),
                atol=0.05 * float(np.abs(np.asarray(jl[name],
                                                    np.float32)).max()))


def test_conversion_round_trip_is_bitwise(pair):
    *_, cfg, model, params, np_params = pair
    back = lm_params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    again = lm_params_from_numpy(cfg, back, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)))


def test_conversion_rejects_a_mismatched_tree(pair):
    *_, cfg, model, params, np_params = pair
    bad = jax.tree_util.tree_map(lambda a: a, np_params)
    bad["final_norm"] = np.zeros(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_init_params_follows_the_template():
    """The port's own init: the JAX package's rule (zeros for norms and
    biases, N(0, 0.02) embeddings, N(0, 1/fan_in) matrices), seeded."""
    _, cfg = _configs("qwen2.5-14b")
    model = build_model(cfg, device="cpu")
    a = model.init_params(torch.Generator().manual_seed(5))
    b = model.init_params(torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    assert len(a["layers"]) == cfg.n_layers
    assert a["embed"].shape == (cfg.vocab_padded, cfg.d_model)
    assert not a["final_norm"].any() and not a["layers"][0]["attn"]["bq"].any()
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    wq = a["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    bf = LanguageModel(cfg, device="cpu", param_dtype=torch.bfloat16) \
        .init_params(torch.Generator().manual_seed(5))
    assert bf["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", sorted(_BUILDABLE))
def test_build_model_runs_each_ported_config(arch):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), d_head=64)
    if cfg.rwkv:            # the WKV heads of 64 span d_model
        cfg = dataclasses.replace(cfg, n_heads=cfg.d_model // 64,
                                  n_kv_heads=cfg.d_model // 64)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    kw, n_in = {}, 9
    if cfg.frontend == "vision_patches":
        kw["patch_embeds"] = torch.randn(
            (1, cfg.n_frontend_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(1))
        n_in += cfg.n_frontend_tokens
    if cfg.is_encdec:
        kw["src_embeds"] = torch.randn(
            (1, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    logits, cache = model.prefill(params, torch.arange(9)[None],
                                  max_len=n_in + 3, **kw)
    assert logits.shape == (1, cfg.vocab_padded)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    logits, cache = model.decode_step(params, cache,
                                      torch.tensor([[3]], dtype=torch.int32))
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()
    assert cache["len"].tolist() == [n_in + 1]


def test_prefill_refuses_a_prompt_longer_than_the_cache():
    _, cfg = _configs("minicpm-2b")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(params, torch.arange(20)[None], max_len=16)
