"""The port's new LM families against the JAX package's, on the CPU: gemma2
(local/global alternation, soft caps), the mixtures of experts (Granite,
Qwen3 with QK-norm), the encoder-decoder (seamless) and the vision-patch
frontend (pixtral), and the int8 KV cache.

Each family at ``reduced_config`` with ``d_head`` 64 (the attention kernels
take 64, 128 and 256), the JAX package's parameters carried across with
``models.convert``, the same numpy inputs from a seed through both:

- prefill logits and 8 teacher-forced decode steps within ``_REL`` (5%) of
  the largest JAX logit (``test_torch_lm.py``'s rule), the greedy token
  equal where the JAX top-1 margin is clear.  gemma2's prompt of 21 tokens
  passes its reduced window of 8, and its decode wraps the ring.
- The mixtures of experts route discretely: a router logit or a capacity
  gate one bfloat16 ulp from a tie flips a (token, expert) pair, and the
  two packages' activations differ by an ulp here and there.  Given equal
  inputs the port's ``moe_apply`` agrees with the JAX one within a
  bfloat16 ulp (``test_torch_moe.py``).  So each decode step records, for every MoE
  layer, the (token, expert) pairs each package kept: where they agree in
  every layer, the step's logits are compared; where they differ, the JAX
  routing must sit at a near-tie (some token's k-th router logit within
  ``_ROUTE_LOGIT_GAP`` of its (k+1)-th, or an over-full expert's C-th
  gate within ``_ROUTE_GATE_GAP`` of its (C+1)-th).  Most steps are
  compared.
- The port's twin of ``test_decode_matches_full_forward`` for gemma2.
- int8 KV: the port's int8 model against JAX's int8 model (qwen2.5,
  gemma2), the quantizer bitwise equal to JAX's (its prefill conversion
  run by the JAX package on the same k/v; the decode write's bfloat16
  arithmetic), and the int8 path keeping bfloat16's top token.
- Parameters round-trip bitwise, the MoE ``[E, ...]`` leaves and the
  encoder-decoder's ``enc_layers``/``cross_layers``/``enc_norm`` included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
import repro_torch.models.moe as port_moe
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model, quantize_kv
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)

_FAMILIES = ["gemma2-2b", "granite-moe-1b-a400m", "qwen3-moe-30b-a3b",
             "seamless-m4t-large-v2", "pixtral-12b"]
_REL = 0.05
_DECODE_STEPS = 8
_PROMPT = 21           # past gemma2's reduced window of 8
_MAX_LEN = 48
_SRC_LEN = 9           # the encoder-decoder's source frames
_ROUTE_LOGIT_GAP = 0.0625
_ROUTE_GATE_GAP = 0.02


def _configs(arch, **over):
    return (dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                d_head=64, **over),
            dataclasses.replace(reduced_config(get_config(arch)), d_head=64,
                                **over))


def _pair(arch, seed=0, jax_kw=None, port_kw=None, **over):
    jcfg, cfg = _configs(arch, **over)
    jmodel = jax_build_model(jcfg, remat=False, **(jax_kw or {}))
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    model = build_model(cfg, device="cpu", **(port_kw or {}))
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, np_params), cfg,
            model, lm_params_from_numpy(cfg, np_params, device="cpu"),
            np_params)


@pytest.fixture(scope="module", params=_FAMILIES)
def pair(request):
    return _pair(request.param)


def _inputs(cfg, rng, b, s):
    """Tokens and the frontends' embeddings -> (JAX batch, port tokens,
    port keywords)."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    extra = {}
    if cfg.frontend == "vision_patches":
        extra["patch_embeds"] = (b, cfg.n_frontend_tokens)
    if cfg.is_encdec:
        extra["src_embeds"] = (b, _SRC_LEN)
    for name, shape in extra.items():
        x = (0.1 * rng.standard_normal(shape + (cfg.d_model,))) \
            .astype(np.float32)
        batch[name] = jnp.asarray(x, jnp.bfloat16)
        kw[name] = torch.from_numpy(x).to(torch.bfloat16)
    return batch, torch.from_numpy(toks), kw


def _check_logits(cfg, jax_logits, port_logits, what):
    want = np.asarray(jax_logits, np.float32)[:, :cfg.vocab_size]
    got = port_logits.numpy()[:, :cfg.vocab_size]
    tol = _REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)
    assert (port_logits.numpy()[:, cfg.vocab_size:] == -1e30).all()
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear], err_msg=what)
    return int(clear.sum())


def _kept(gates: np.ndarray, cap: int) -> np.ndarray:
    """[T,E] gates -> [T,E] bool: the (token, expert) pairs an expert keeps,
    its top ``cap`` tokens by gate (the lower token first on ties) with a
    gate > 0."""
    kept = np.zeros(gates.shape, bool)
    for e, col in enumerate(gates.T):
        top = np.argsort(-col, kind="stable")[:cap]
        kept[top, e] = col[top] > 0
    return kept


def _routing_is_clear(cfg, xf, router, gates, cap) -> bool:
    """The JAX MoE call's routing, away from every tie (see the module
    docstring)."""
    logits = np.asarray((xf @ router).astype(jnp.float32))
    k = cfg.experts_per_token
    ranked = -np.sort(-logits, axis=-1)
    if (ranked[:, k - 1] - ranked[:, k] <= _ROUTE_LOGIT_GAP).any():
        return False
    for col in gates.T:
        routed = np.sort(col[col > 0])[::-1]
        if len(routed) > cap and routed[cap - 1] - routed[cap] \
                <= _ROUTE_GATE_GAP:
            return False
    return True


def _spy_on_routing(monkeypatch, cfg):
    """Record, for every eager MoE call of either package, the pairs kept
    (and, for JAX, whether its routing is clear) -> (jax_calls,
    port_calls)."""
    jax_calls, port_calls = [], []
    jax_apply, port_apply = jax_moe.moe_apply, port_moe.moe_apply

    def jax_spy(c, p, x, capacity_factor=2.0):
        if not isinstance(x, jax.core.Tracer):      # decode is eager
            xf = x.reshape(-1, x.shape[-1])
            gates = np.asarray(jax_moe._route(c, xf, p["router"]))
            cap = min(jax_moe._capacity(c, xf.shape[0], capacity_factor),
                      xf.shape[0])
            jax_calls.append((_kept(gates, cap), _routing_is_clear(
                c, xf, p["router"], gates, cap)))
        return jax_apply(c, p, x, capacity_factor)

    def port_spy(c, p, x, capacity_factor=2.0, counts=None):
        xf = x.reshape(-1, x.shape[-1])
        gates = port_moe._route(c, xf, p["router"]).numpy()
        cap = min(port_moe._capacity(c, xf.shape[0], capacity_factor),
                  xf.shape[0])
        port_calls.append(_kept(gates, cap))
        return port_apply(c, p, x, capacity_factor, counts)

    monkeypatch.setattr(jax_moe, "moe_apply", jax_spy)
    monkeypatch.setattr(port_moe, "moe_apply", port_spy)
    return jax_calls, port_calls


def test_prefill_and_teacher_forced_decode_match_jax(pair, monkeypatch):
    jmodel, jparams, cfg, model, params, _ = pair
    jax_calls, port_calls = _spy_on_routing(monkeypatch, cfg)
    rng = np.random.default_rng(1)
    batch, toks, kw = _inputs(cfg, rng, 2, _PROMPT)
    jl, jcache = jmodel.prefill(jparams, batch, max_len=_MAX_LEN)
    tl, cache = model.prefill(params, toks, max_len=_MAX_LEN, **kw)
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_padded)
    compared = _check_logits(cfg, jl, tl, "prefill")
    n_in = _PROMPT + (cfg.n_frontend_tokens
                      if cfg.frontend == "vision_patches" else 0)
    assert cache["len"].tolist() == [n_in] * 2
    steps_compared = 0
    for step in range(_DECODE_STEPS):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        del jax_calls[:], port_calls[:]
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        n_moe = cfg.n_layers if cfg.n_experts else 0
        assert len(jax_calls) == len(port_calls) == n_moe
        same = [np.array_equal(jk, pk)
                for (jk, _), pk in zip(jax_calls, port_calls)]
        if all(same):
            compared += _check_logits(cfg, jl, tl, f"decode step {step}")
            steps_compared += 1
        else:       # a flipped pair only where the JAX routing is near a tie
            assert not all(clear for (_, clear), eq in zip(jax_calls, same)
                           if not eq), f"decode step {step}"
    assert cache["len"].tolist() == [n_in + _DECODE_STEPS] * 2
    assert compared > 0 and steps_compared > _DECODE_STEPS // 2


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
    if cfg.is_encdec:
        assert len(params["enc_layers"]) == cfg.n_encoder_layers
        assert len(params["cross_layers"]) == cfg.n_layers
        assert params["enc_norm"].shape == (cfg.d_model,)
    if cfg.n_experts:
        assert params["layers"][0]["moe"]["wi"].shape == (
            cfg.n_experts, cfg.d_model, cfg.d_ff)


def test_gemma2_alternates_local_and_global_layers():
    _, cfg = _configs("gemma2-2b")
    cfg = dataclasses.replace(cfg, n_layers=4)
    model = build_model(cfg, device="cpu")
    assert model._layer_flags() == [False, True, False, True]
    caps = [layer["k"][0][1] for layer in
            model.cache_specs(2, _MAX_LEN)["layers"]]
    assert caps == [cfg.window_size, _MAX_LEN] * 2


def test_gemma2_decode_matches_full_forward():
    """The port's twin of the JAX package's test: prefill(t[:n]) +
    decode(t[n]) logits == prefill(t[:n+1]) logits, past the window."""
    _, cfg = _configs("gemma2-2b")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 10)).astype(np.int32))
    _, cache = model.prefill(params, toks[:, :9], max_len=16)
    step_logits, _ = model.decode_step(params, cache, toks[:, 9:10])
    full_logits, _ = model.prefill(params, toks, max_len=16)
    np.testing.assert_allclose(step_logits.numpy(), full_logits.numpy(),
                               atol=0.15, rtol=0.05)


def test_encdec_and_patch_inputs_are_checked():
    _, enc = _configs("seamless-m4t-large-v2")
    model = build_model(enc, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="src_embeds"):
        model.prefill(params, torch.arange(5)[None])
    src = torch.zeros((1, 7, enc.d_model), dtype=torch.bfloat16)
    _, cache = model.prefill(params, torch.arange(5)[None], max_len=8,
                             src_embeds=src)
    assert cache["enc_out"].shape == (1, 7, enc.d_model)
    assert model.cache_specs(1, 40)["enc_out"][0] == (1, 10, enc.d_model)
    _, dense = _configs("qwen2.5-14b")
    model = build_model(dense, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no encoder"):
        model.prefill(params, torch.arange(5)[None], src_embeds=src)
    with pytest.raises(ValueError, match="patch embeddings"):
        model.prefill(params, torch.arange(5)[None],
                      patch_embeds=src[:, :2])


# -- int8 KV cache -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma2-2b"])
def test_int8_kv_cache_matches_jax_int8(arch):
    jmodel, jparams, cfg, model, params, _ = _pair(
        arch, seed=6, jax_kw={"kv_cache_dtype": jnp.int8},
        port_kw={"kv_cache_dtype": torch.int8})
    rng = np.random.default_rng(6)
    batch, toks, _ = _inputs(cfg, rng, 2, _PROMPT)
    jl, jcache = jmodel.prefill(jparams, batch, max_len=_MAX_LEN)
    tl, cache = model.prefill(params, toks, max_len=_MAX_LEN)
    specs = model.cache_specs(2, _MAX_LEN)["layers"]
    for lc, jlc, spec in zip(cache["layers"], jcache["layers"], specs):
        assert set(lc) == set(jlc) == {"k", "v", "k_scale", "v_scale"}
        for name, (shape, dtype) in spec.items():
            assert lc[name].dtype == dtype and tuple(lc[name].shape) == shape
    assert cache["layers"][0]["k"].dtype == torch.int8
    compared = _check_logits(cfg, jl, tl, "prefill")
    for step in range(_DECODE_STEPS):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        compared += _check_logits(cfg, jl, tl, f"decode step {step}")
    assert compared > 0


def test_int8_prefill_quantizer_is_bitwise_jax():
    """The same bfloat16 k/v through the JAX package's prefill conversion
    (ring buffers for gemma2's local layers, full buffers for its global
    ones) and the port's: int8 values and float32 scales bitwise equal."""
    _, cfg = _configs("gemma2-2b")
    jcfg, _ = _configs("gemma2-2b")
    jmodel = jax_build_model(jcfg, remat=False, kv_cache_dtype=jnp.int8)
    model = build_model(cfg, device="cpu", kv_cache_dtype=torch.int8)
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, 2, _PROMPT, cfg.n_kv_heads, cfg.d_head)
    kv = {n: (3.0 * rng.standard_normal(shape)).astype(np.float32)
          for n in ("k", "v")}
    kv["k"][0, 1, 4] = 0.0                  # an all-zero token
    jax_caches = {n: jnp.asarray(a, jnp.bfloat16) for n, a in kv.items()}
    port_caches = [{n: torch.from_numpy(a[i]).to(torch.bfloat16)
                    for n, a in kv.items()} for i in range(cfg.n_layers)]
    want = jmodel._prefill_caches_to_decode(jax_caches, _PROMPT, _MAX_LEN)
    got = model._prefill_caches_to_decode(port_caches, 2, _PROMPT, _MAX_LEN)
    for jl, tl in zip(want, got):
        for name in ("k", "v", "k_scale", "v_scale"):
            a, b = np.asarray(jl[name]), tl[name].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name


def test_int8_decode_quantizer_is_bitwise_jax():
    """The decode write quantizes the new token in bfloat16, as the JAX
    decode step does (``transformer.py``'s ``quant``): a copy of its
    expression on the same bfloat16 values, with exact halves, zeros and
    large values among them."""
    rng = np.random.default_rng(8)
    x = (4.0 * rng.standard_normal((64, 4, 64))).astype(np.float32)
    x[0] = 0.0
    x[1, :, :2] = [126.5, -127.0]
    x[2] *= 1e-4
    val = jnp.asarray(x, jnp.bfloat16)
    sc = jnp.maximum(jnp.max(jnp.abs(val), axis=-1), 1e-6) / 127.
    want_q = jnp.clip(jnp.round(val / sc[..., None]), -127, 127) \
        .astype(jnp.int8)
    want_s = sc.astype(jnp.float32)
    got_q, got_s = quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    assert np.array_equal(np.asarray(want_q), got_q.numpy())
    assert np.array_equal(np.asarray(want_s), got_s.numpy())


def test_int8_kv_cache_keeps_bf16_top_token():
    """The port's twin of ``test_int8_kv_cache_decode_close_to_bf16``."""
    _, cfg = _configs("qwen2.5-14b")
    m16 = build_model(cfg, device="cpu")
    m8 = build_model(cfg, device="cpu", kv_cache_dtype=torch.int8)
    params = m16.init_params(torch.Generator().manual_seed(6))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 9)).astype(np.int32))
    _, c16 = m16.prefill(params, toks, max_len=16)
    _, c8 = m8.prefill(params, toks, max_len=16)
    nxt = torch.tensor([[5]], dtype=torch.int32)
    l16, _ = m16.decode_step(params, c16, nxt)
    l8, _ = m8.decode_step(params, c8, nxt)
    assert int(l16.argmax()) == int(l8.argmax())


def test_kv_cache_dtype_is_checked():
    _, cfg = _configs("qwen2.5-14b")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        build_model(cfg, device="cpu", kv_cache_dtype=torch.float16)
