"""The port's RWKV-6 path against the JAX package's, on the CPU.

- The WKV6 plain version (``kernels/rwkv6_scan/ref.py``, the CPU side of
  the kernel wrapper) against the JAX Pallas kernel in interpret mode and
  against ``wkv6_reference``, at ``tests/test_kernels.py``'s shapes and
  under strong decay (w = 1e-6), within that file's 3e-4; its final state
  against ``wkv6_chunked``'s (the form the JAX model runs).
- ``wkv6_chunked_ref``, the CUDA kernel's chunk-parallel decomposition in
  plain torch (chunk-local states, the state pass across chunks, the
  outputs), against the JAX Pallas kernel in interpret mode and the
  per-step recurrence, on y and the final state, within 3e-4: the same
  shapes, strong decay over 13 chunks with B 2, B 3 with S off the chunk,
  and one step.  The kernel itself runs only on the card
  (``tests/test_torch_kernels_cuda.py``); this pins its algorithm here.
- ``rwkv_time_mix`` and ``rwkv_channel_mix`` against JAX's on the same
  float32 parameters and inputs, for a sequence and for a decode step.
- ``reduced_config(rwkv6-1.6b)`` with 2 heads of 64 (the kernel takes head
  size 64 only) and d_model 128: prefill and decode logits against the
  JAX model within 5% of the largest JAX logit (both round activations to
  bfloat16, at other places), the port's own prefill + decode against a
  longer prefill, the engine's greedy tokens against the JAX engine's where
  the JAX margin is clear, and a bitwise parameter round trip.

All inputs are numpy arrays from a seed; nothing sets global state.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_rwkv6_scan
from repro.models import build_model as jax_build_model
from repro.models import rwkv6 as jax_rwkv
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.rwkv6_scan import ops as scan_ops
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as scan_kernel
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_chunked_ref,
                                                wkv6_scan_ref)
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.serve import InferenceEngine, Request, ServeConfig

_ATOL = 3e-4          # tests/test_kernels.py's tolerance for the scan
_REL = 0.05           # logits, relative to the largest JAX logit
_ARCH = "rwkv6-1.6b"
_SMALL = dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64)


def _scan_inputs(seed, b, s, h, kk, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(b, s, h, kk)).astype(np.float32)
               for _ in range(3))
    if strong:
        w = np.full((b, s, h, kk), 1e-6, np.float32)
    else:
        w = (1 / (1 + np.exp(-rng.normal(size=(b, s, h, kk)))) * 0.5
             + 0.45).astype(np.float32)
    u = (0.1 * rng.normal(size=(h, kk))).astype(np.float32)
    return r, k, v, w, u


_SHAPES = [  # tests/test_kernels.py: (b, s, h, kk, chunk), plus strong decay
    (1, 32, 2, 64, 16, False), (2, 48, 4, 64, 16, False),
    (1, 40, 1, 64, 8, False), (1, 32, 2, 64, 16, True),
    (3, 37, 2, 64, 16, False),
]


@pytest.mark.parametrize("b,s,h,kk,chunk,strong", _SHAPES)
def test_plain_scan_matches_the_jax_kernel_and_reference(b, s, h, kk, chunk,
                                                         strong):
    arrays = _scan_inputs(s + b, b, s, h, kk, strong)
    t = [torch.from_numpy(a) for a in arrays]
    before = scan_ops.launches
    y, state = scan_ops.rwkv6_scan(*t)
    assert scan_ops.launches == before        # CPU: the plain version
    assert y.dtype == state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    j = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(jax_rwkv6_scan(*j, chunk=chunk))   # interpret mode
    np.testing.assert_allclose(y.numpy(), kernel, atol=_ATOL)
    ref = np.asarray(jax_rwkv.wkv6_reference(*j))
    np.testing.assert_allclose(y.numpy(), ref, atol=_ATOL)
    y_chunked, st_chunked = jax_rwkv.wkv6_chunked(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_chunked), atol=_ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(st_chunked),
                               atol=_ATOL)


# (b, s, h, kk, chunk of the JAX kernel, strong decay): the shapes above,
# then the state pass between chunks: strong decay over 13 chunks of 16
# with B 2, B 3 over 4 chunks with S off the chunk, and one step.
_CHUNKED_SHAPES = _SHAPES + [
    (2, 200, 3, 64, 16, True), (3, 53, 2, 64, 16, False),
    (2, 1, 3, 64, 16, False),
]


@pytest.mark.parametrize("b,s,h,kk,chunk,strong", _CHUNKED_SHAPES)
def test_chunked_mirror_matches_the_jax_kernel_and_reference(b, s, h, kk,
                                                             chunk, strong):
    arrays = _scan_inputs(s + b, b, s, h, kk, strong)
    y, state = wkv6_chunked_ref(*(torch.from_numpy(a) for a in arrays))
    assert y.dtype == state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    y_ref, st_ref = wkv6_scan_ref(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=_ATOL)
    np.testing.assert_allclose(state.numpy(), st_ref.numpy(), atol=_ATOL)
    kernel = np.asarray(jax_rwkv6_scan(*(jnp.asarray(a) for a in arrays),
                                       chunk=chunk))     # interpret mode
    np.testing.assert_allclose(y.numpy(), kernel, atol=_ATOL)


def test_binding_chunk_matches_the_cuda_source():
    """The binding's chunk length (the mirror's and the scratch size's) is
    the CUDA source's."""
    source = scan_kernel.SOURCE.read_text()
    assert re.search(r"constexpr int Q = (\d+);", source).group(1) \
        == str(scan_kernel.CHUNK)
    n_chunks = -(-699 // scan_kernel.CHUNK)
    assert scan_kernel.scratch_floats(1, 699, 32) \
        == 32 * n_chunks * (64 * 64 + 64)


def test_plain_scan_carries_an_initial_state():
    r, k, v, w, u = _scan_inputs(3, 2, 21, 2, 64)
    st0 = (0.3 * np.random.default_rng(4).normal(size=(2, 2, 64, 64))
           ).astype(np.float32)
    y, st = wkv6_scan_ref(*(torch.from_numpy(a) for a in
                            (r, k, v, w, u, st0)))
    jy, jst = jax_rwkv.wkv6_chunked(*(jnp.asarray(a) for a in
                                      (r, k, v, w, u, st0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=_ATOL)
    # a split sequence equals the whole one
    t = [torch.from_numpy(a) for a in (r, k, v, w)]
    y1, st1 = wkv6_scan_ref(*(a[:, :9] for a in t), torch.from_numpy(u))
    y2, st2 = wkv6_scan_ref(*(a[:, 9:] for a in t), torch.from_numpy(u), st1)
    yw, stw = wkv6_scan_ref(*t, torch.from_numpy(u))
    torch.testing.assert_close(torch.cat([y1, y2], 1), yw, atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(st2, stw, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bad", ["head_size", "shapes", "u", "state_dtype",
                                 "state", "int_dtype", "mixed_dtypes"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    r, k, v, w, u = (torch.from_numpy(a) for a in _scan_inputs(0, 1, 8, 2,
                                                               64))
    state = None
    if bad == "head_size":
        r, k, v, w, u = r[..., :32], k[..., :32], v[..., :32], w[..., :32], \
            u[:, :32]
    elif bad == "shapes":
        w = w[:, :7]
    elif bad == "u":
        u = u[:1]
    elif bad == "state_dtype":
        state = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    elif bad == "state":        # the kernel starts from zeros, always
        state = torch.zeros((1, 2, 64, 64))
    elif bad == "int_dtype":
        r = r.to(torch.int32)
    else:                       # r, k, v, u share one dtype (w may differ)
        k = k.to(torch.bfloat16)
    with pytest.raises(ValueError, match="rwkv6_scan"):
        scan_ops.rwkv6_scan(r, k, v, w, u, state)


# ------------------------------------------------------------------ blocks

def _configs(**extra):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(_ARCH)),
                               **_SMALL, **extra)
    cfg = dataclasses.replace(reduced_config(get_config(_ARCH)), **_SMALL,
                              **extra)
    return jcfg, cfg


def _jax_params(jmodel, seed):
    """The JAX package's init, with its zero-initialized mixes, norms and
    bonus drawn at random so that every path counts."""
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for name, a in params["layers"].items():
        if not a.any():
            params["layers"][name] = (0.3 * rng.normal(size=a.shape)) \
                .astype(np.float32)
    return params


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _configs()
    jmodel = jax_build_model(jcfg, remat=False)
    np_params = _jax_params(jmodel, 0)
    return (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
            cfg, build_model(cfg, device="cpu"),
            lm_params_from_numpy(cfg, np_params, device="cpu"), np_params)


def _layer0(np_params):
    lp = {k: np.array(v[0]) for k, v in np_params["layers"].items()}
    return {k[3:]: v for k, v in lp.items() if k.startswith("tm_")}


@pytest.mark.parametrize("s", [13, 1])
def test_time_and_channel_mix_match_jax(pair, s):
    """Float32 parameters and inputs through both packages; s = 1 with a
    state is the decode step (the plain recurrence, no kernel)."""
    jcfg, _, _, cfg, _, _, np_params = pair
    tm = _layer0(np_params)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    state = None
    if s == 1:
        state = {"tm_shift": rng.normal(size=(2, 1, cfg.d_model)),
                 "cm_shift": rng.normal(size=(2, 1, cfg.d_model)),
                 "wkv": 0.3 * rng.normal(size=(2, 2, 64, 64))}
        state = {k: v.astype(np.float32) for k, v in state.items()}
    jtm = {k: jnp.asarray(v) for k, v in tm.items()}
    ttm = {k: torch.from_numpy(v) for k, v in tm.items()}
    jst = None if state is None else {k: jnp.asarray(v)
                                      for k, v in state.items()}
    tst = None if state is None else {k: torch.from_numpy(v)
                                      for k, v in state.items()}
    jy, jnew = jax_rwkv.rwkv_time_mix(jcfg, jtm, jnp.asarray(x), jst)
    ty, tnew = rwkv.rwkv_time_mix(cfg, ttm, torch.from_numpy(x), tst)
    tol = 1e-4 * float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tol, rtol=0)
    np.testing.assert_allclose(tnew["wkv"].numpy(), np.asarray(jnew["wkv"]),
                               atol=1e-4 * float(np.abs(np.asarray(
                                   jnew["wkv"])).max()), rtol=0)
    np.testing.assert_array_equal(tnew["tm_shift"].numpy(),
                                  np.asarray(jnew["tm_shift"]))
    jy, jnew = jax_rwkv.rwkv_channel_mix(jcfg, jtm, jnp.asarray(x), jst)
    ty, tnew = rwkv.rwkv_channel_mix(cfg, ttm, torch.from_numpy(x), tst)
    np.testing.assert_allclose(
        ty.numpy(), np.asarray(jy),
        atol=1e-5 * float(np.abs(np.asarray(jy)).max()), rtol=0)
    np.testing.assert_array_equal(tnew["cm_shift"].numpy(),
                                  np.asarray(jnew["cm_shift"]))


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


def test_prefill_and_decode_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params, _ = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                max_len=64)
    tl, cache = model.prefill(params, torch.from_numpy(toks), max_len=64)
    _check_logits(cfg, jl, tl, "prefill")
    for jlc, tlc in zip(jcache["layers"], cache["layers"]):
        assert set(tlc) == {"tm_shift", "wkv", "cm_shift"}
        assert tlc["wkv"].dtype == torch.float32
        assert tlc["tm_shift"].dtype == tlc["cm_shift"].dtype \
            == torch.bfloat16           # cache_specs, not JAX's float32
        want = np.asarray(jlc["wkv"])
        np.testing.assert_allclose(tlc["wkv"].numpy(), want,
                                   atol=_REL * np.abs(want).max())
    for step in range(4):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        _check_logits(cfg, jl, tl, f"decode step {step}")
    assert cache["len"].tolist() == [41, 41]


def test_prefill_then_decode_equals_a_longer_prefill(pair):
    *_, cfg, model, params, _ = pair
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 14)).astype(np.int32))
    want, _ = model.prefill(params, toks, max_len=32)
    _, cache = model.prefill(params, toks[:, :12], max_len=32)
    for i in (12, 13):
        got, cache = model.decode_step(params, cache, toks[:, i:i + 1])
    tol = _REL * float(want.abs().max())
    torch.testing.assert_close(got[:, :cfg.vocab_size],
                               want[:, :cfg.vocab_size], atol=tol, rtol=0)


def test_cache_specs_are_what_prefill_hands_over(pair):
    *_, cfg, model, params, _ = pair
    _, cache = model.prefill(params, torch.arange(5)[None], max_len=16)
    specs = model.cache_specs(1, 16)
    assert len(cache["layers"]) == len(specs["layers"]) == cfg.n_layers
    for lc, spec in zip(cache["layers"], specs["layers"]):
        assert {k: (tuple(v.shape), v.dtype) for k, v in lc.items()} == spec


def test_greedy_engine_matches_jax_engine_where_clear(pair, monkeypatch):
    """Both engines serve the same requests on the same weights; tokens are
    compared up to the first position where the JAX model's top-1 margin is
    within twice the logit tolerance.  Every prefill, the one-token prompt's
    too, goes through the scan's kernel wrapper, once a layer."""
    jcfg, jmodel, jparams, cfg, model, params, _ = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 11, 1)]
    calls = []
    wrapper = scan_ops.rwkv6_scan
    monkeypatch.setattr(scan_ops, "rwkv6_scan",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    jeng = JaxEngine(jmodel, JaxServeConfig(n_slots=2, max_len=32,
                                            eos_token=-1))
    eng = InferenceEngine(model, ServeConfig(n_slots=2, max_len=32,
                                             eos_token=-1))
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=4))
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=4))
    before = scan_ops.launches
    jeng.run_until_drained(jparams)
    eng.run_until_drained(params)
    assert scan_ops.launches == before and eng.prefills == 4
    assert len(calls) == cfg.n_layers * eng.prefills
    assert sorted({c[1] for c in calls}) == [1, 5, 11, 19]
    jout = {r.rid: r.output for r in jeng.completed}
    out = {r.rid: r.output for r in eng.completed}
    compared = 0
    for i, p in enumerate(prompts):
        logits, cache = jmodel.prefill(
            jparams, {"tokens": jnp.asarray(p)[None]}, max_len=32)
        for pos, tok in enumerate(jout[i]):
            row = np.asarray(logits, np.float32)[0, :cfg.vocab_size]
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= 2 * _REL * np.abs(row).max():
                break
            assert out[i][pos] == tok, (i, pos)
            compared += 1
            logits, cache = jmodel.decode_step(
                jparams, cache, jnp.asarray([[tok]], jnp.int32))
    assert compared > 0


def test_conversion_round_trip_is_bitwise(pair):
    *_, cfg, model, params, np_params = pair
    assert set(params["layers"][0]) == set(np_params["layers"])
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
