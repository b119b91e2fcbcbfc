"""The port's Hymba path (parallel attention and SSD heads) against the JAX
package's, on the CPU.

- The SSD plain version (``kernels/ssd_scan/ref.py``, the CPU side of the
  kernel wrapper) against the JAX Pallas kernel in interpret mode and
  against ``ssd_reference``, at ``tests/test_kernels.py``'s shapes and at
  Hymba's head width and state size, within that file's 3e-4; its final
  state against ``ssd_chunked``'s where that is finite.
- ``ssd_chunked_ref``, the CUDA kernel's chunk-parallel decomposition in
  plain torch (chunk-local states, the state pass across chunks, the
  outputs, chunks of 64), against the JAX Pallas kernel in interpret mode
  and the per-step recurrence, on y and the final state, within 3e-4: the
  same shapes, strong decay over 18 chunks with B 2, B 3 with S, P and N
  off the kernel's tiles, and one step.  The Pallas kernel differences
  float32 cumsums for its exponents and drifts past 3e-4 under strong
  decay on some inputs; the kernel and its mirror sum in float64 and stay
  within: a test shows both.
- The JAX package's ``ssd_chunked`` turns NaN once a chunk is long enough
  (S = 128, dt 0.7, a = -1: ``exp(csum_t - csum_s)`` for t < s overflows
  before the triangular mask multiplies it by 0).  The Pallas kernel clamps
  those exponents and stays finite, and so does the port: a test shows the
  fault and the agreement.  The JAX Hymba model runs ``ssd_chunked``, so
  the model tests below use prompts short enough that it stays finite.
- ``ssm_apply`` against JAX's on the same float32 parameters and inputs,
  for a sequence and for a decode step.
- ``reduced_config(hymba-1.5b)`` with ``d_head`` 64 (the attention kernels
  take 64, 128 and 256): window 8, layer 0 global and layer 1 sliding,
  prefill and decode logits against the JAX model within 5% of the largest
  JAX logit, the decode cache (ring buffer included) against JAX's, the
  port's own prefill + decode past the window against a longer prefill, the
  engine's greedy tokens against the JAX engine's where the JAX margin is
  clear, and a bitwise parameter round trip.

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
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.serve import InferenceEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.kernels.ssd_scan import ssd_scan as scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.serve import InferenceEngine, Request, ServeConfig

_ATOL = 3e-4          # tests/test_kernels.py's tolerance for the scan
_REL = 0.05           # logits, relative to the largest JAX logit
_ARCH = "hymba-1.5b"


def _scan_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.normal(size=(b, s, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = (-np.exp(0.3 * rng.normal(size=(h,)))).astype(np.float32)
    bm = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    cm = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    return x, dt, a, bm, cm


_SHAPES = [  # tests/test_kernels.py: (b, s, h, p, n, chunk), plus Hymba's
    (1, 32, 2, 8, 4, 16), (2, 64, 3, 16, 8, 16), (1, 48, 2, 8, 4, 8),
    (2, 150, 2, 64, 16, 128),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", _SHAPES)
def test_plain_scan_matches_the_jax_kernel_and_reference(b, s, h, p, n,
                                                         chunk):
    arrays = _scan_inputs(s + p, b, s, h, p, n)
    before = scan_ops.launches
    y, state = scan_ops.ssd_scan(*(torch.from_numpy(a) for a in arrays))
    assert scan_ops.launches == before        # CPU: the plain version
    assert y.dtype == state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    j = [jnp.asarray(a) for a in arrays]
    kernel = np.asarray(jax_ssd_scan(*j, chunk=chunk))      # interpret mode
    np.testing.assert_allclose(y.numpy(), kernel, atol=_ATOL)
    ref, ref_state = jax_ssm.ssd_reference(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=_ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                               atol=_ATOL)
    y_chunked, st_chunked = jax_ssm.ssd_chunked(*j, chunk=chunk)
    if s <= 64:             # short chunks: the JAX chunked form is finite
        np.testing.assert_allclose(y.numpy(), np.asarray(y_chunked),
                                   atol=_ATOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(st_chunked),
                                   atol=_ATOL)


def _strong(arrays):
    """dt * |a| up to ~300 a step, as chip_smoke's strong-decay cases."""
    x, dt, a, bm, cm = arrays
    return x, dt * 30, a * 10, bm, cm


# (b, s, h, p, n, chunk of the JAX kernel, strong decay): the shapes
# above, then the state pass between chunks: strong decay over 18 chunks of
# 64 with B 2, B 3 over 4 chunks with S, P and N off the kernel's tiles,
# and one step.
_CHUNKED_SHAPES = [shape + (False,) for shape in _SHAPES] + [
    (2, 1100, 3, 64, 16, 64, True), (3, 200, 2, 18, 12, 64, False),
    (2, 1, 3, 64, 16, 64, False),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,strong", _CHUNKED_SHAPES)
def test_chunked_mirror_matches_the_jax_kernel_and_reference(b, s, h, p, n,
                                                             chunk, strong):
    arrays = _scan_inputs(s + p, b, s, h, p, n)
    if strong:
        arrays = _strong(arrays)
    y, state = ssd_chunked_ref(*(torch.from_numpy(a) for a in arrays))
    assert y.dtype == state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    y_ref, st_ref = ssd_scan_ref(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=_ATOL)
    np.testing.assert_allclose(state.numpy(), st_ref.numpy(), atol=_ATOL)
    kernel = np.asarray(jax_ssd_scan(*(jnp.asarray(a) for a in arrays),
                                     chunk=chunk))       # interpret mode
    np.testing.assert_allclose(y.numpy(), kernel, atol=_ATOL)


def test_jax_kernel_drifts_under_strong_decay_where_the_mirror_does_not():
    """Strong decay (2, 1100, 3, 64, 16): the Pallas kernel's exponents are
    differences of float32 cumsums that reach ~1e4 within a chunk, so on
    these inputs its y is off the per-step recurrence by more than 3e-4 at
    either chunk length; the mirror, which sums in float64, is within."""
    arrays = _strong(_scan_inputs(1, 2, 1100, 3, 64, 16))
    y_ref, st_ref = ssd_scan_ref(*(torch.from_numpy(a) for a in arrays))
    for chunk in (64, 128):
        kernel = np.asarray(jax_ssd_scan(*(jnp.asarray(a) for a in arrays),
                                         chunk=chunk))
        assert np.isfinite(kernel).all()
        assert np.abs(kernel - y_ref.numpy()).max() > _ATOL
    y, state = ssd_chunked_ref(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=_ATOL)
    np.testing.assert_allclose(state.numpy(), st_ref.numpy(), atol=_ATOL)


def test_binding_chunk_matches_the_cuda_source():
    """The binding's chunk length (the mirror's and the scratch size's) is
    the CUDA source's."""
    source = scan_kernel.SOURCE.read_text()
    assert re.search(r"constexpr int Q = (\d+);", source).group(1) \
        == str(scan_kernel.CHUNK)
    n_chunks = -(-1300 // scan_kernel.CHUNK)
    assert scan_kernel.scratch_floats(1, 1300, 50, 64, 16) \
        == 50 * n_chunks * (64 * 16 + 1)


def test_jax_ssd_chunked_overflows_where_the_kernels_stay_finite():
    """S = 128 in one chunk, dt ~ 0.7, a = -1 (Hymba's init): the JAX
    chunked form is non-finite; the Pallas kernel (interpret mode), the
    per-step reference and the port's plain version agree and are
    finite."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 128, 2, 64, 16
    x = (0.5 * rng.normal(size=(b, s, h, p))).astype(np.float32)
    dt = np.full((b, s, h), 0.7, np.float32)
    a = np.full((h,), -1.0, np.float32)
    bm = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    cm = (0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    y_chunked, _ = jax_ssm.ssd_chunked(*j)
    assert not np.isfinite(np.asarray(y_chunked)).all()
    kernel = np.asarray(jax_ssd_scan(*j, chunk=128))
    y, state = scan_ops.ssd_scan(*(torch.from_numpy(v)
                                   for v in (x, dt, a, bm, cm)))
    assert np.isfinite(kernel).all() and torch.isfinite(y).all()
    np.testing.assert_allclose(y.numpy(), kernel, atol=_ATOL)
    ref, ref_state = jax_ssm.ssd_reference(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=_ATOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                               atol=_ATOL)


def test_plain_scan_carries_an_initial_state():
    x, dt, a, bm, cm = _scan_inputs(5, 2, 40, 2, 16, 8)
    h0 = (0.3 * np.random.default_rng(6).normal(size=(2, 2, 16, 8))
          ).astype(np.float32)
    y, st = ssd_scan_ref(*(torch.from_numpy(v) for v in
                           (x, dt, a, bm, cm, h0)))
    jy, jst = jax_ssm.ssd_chunked(*(jnp.asarray(v) for v in
                                    (x, dt, a, bm, cm, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=_ATOL)


@pytest.mark.parametrize("bad", ["head_dim", "state", "dt", "a", "h0",
                                 "h0_valid", "int_dtype", "mixed_dtypes"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                        _scan_inputs(0, 1, 8, 2, 64, 16))
    h0 = None
    if bad == "head_dim":
        x = torch.zeros((1, 8, 2, 65))
    elif bad == "state":
        bm = cm = torch.zeros((1, 8, 17))
    elif bad == "dt":
        dt = dt[:, :7]
    elif bad == "a":
        a = a[:1]
    elif bad == "h0":
        h0 = torch.zeros((1, 2, 64, 8))
    elif bad == "h0_valid":     # the kernel starts from zeros, always
        h0 = torch.zeros((1, 2, 64, 16))
    elif bad == "int_dtype":
        x = x.to(torch.int32)
    else:                       # x, dt, B, C share one dtype (a may differ)
        bm = bm.to(torch.bfloat16)
    with pytest.raises(ValueError, match="ssd_scan"):
        scan_ops.ssd_scan(x, dt, a, bm, cm, h0)


# ------------------------------------------------------------------ blocks

def _configs():
    return (dataclasses.replace(jax_reduced_config(jax_get_config(_ARCH)),
                                d_head=64),
            dataclasses.replace(reduced_config(get_config(_ARCH)),
                                d_head=64))


def _randomize_zeros(tree, rng):
    """Draw the JAX init's zero-initialized norms, biases and a_log at
    random, so that every path counts."""
    for name, a in tree.items():
        if isinstance(a, dict):
            _randomize_zeros(a, rng)
        elif not a.any():
            tree[name] = (0.3 * rng.normal(size=a.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _configs()
    jmodel = jax_build_model(jcfg, remat=False)
    np_params = jax.tree_util.tree_map(
        np.array, jmodel.init_params(jax.random.PRNGKey(0)))
    _randomize_zeros(np_params["layers"], np.random.default_rng(100))
    return (jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
            cfg, build_model(cfg, device="cpu"),
            lm_params_from_numpy(cfg, np_params, device="cpu"), np_params)


@pytest.mark.parametrize("s", [13, 1])
def test_ssm_apply_matches_jax(pair, s):
    """Float32 parameters and inputs through both packages; s = 1 with a
    state is the decode step (the plain recurrence, no kernel)."""
    jcfg, _, _, cfg, _, _, np_params = pair
    sp = {k: v[0] for k, v in np_params["layers"]["ssm"].items()}
    rng = np.random.default_rng(s)
    u = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    state = None
    if s == 1:
        inner = cfg.ssm_expand * cfg.d_model
        state = {"conv": rng.normal(size=(2, 3, inner + 2 * cfg.ssm_state)),
                 "ssd": 0.3 * rng.normal(size=(2, inner // 64, 64,
                                               cfg.ssm_state))}
        state = {k: v.astype(np.float32) for k, v in state.items()}
    jy, jst = jax_ssm.ssm_apply(
        jcfg, {k: jnp.asarray(v) for k, v in sp.items()}, jnp.asarray(u),
        None if state is None else {k: jnp.asarray(v)
                                    for k, v in state.items()})
    ty, tst = ssm.ssm_apply(
        cfg, {k: torch.from_numpy(v) for k, v in sp.items()},
        torch.from_numpy(u),
        None if state is None else {k: torch.from_numpy(v)
                                    for k, v in state.items()})
    for got, want in ((ty, jy), (tst["ssd"], jst["ssd"]),
                      (tst["conv"], jst["conv"])):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


def _check_logits(cfg, jax_logits, port_logits, what):
    want = np.asarray(jax_logits, np.float32)[:, :cfg.vocab_size]
    got = port_logits.numpy()[:, :cfg.vocab_size]
    assert np.isfinite(want).all(), what
    tol = _REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)
    assert (port_logits.numpy()[:, cfg.vocab_size:] == -1e30).all()
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear], err_msg=what)


def test_prefill_and_decode_match_jax(pair):
    """A 37-token prompt: past the window of 8, so layer 1's ring buffer
    wraps in the prefill and again while decoding."""
    jcfg, jmodel, jparams, cfg, model, params, _ = pair
    assert model._layer_flags() == [True, False]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                max_len=64)
    tl, cache = model.prefill(params, torch.from_numpy(toks), max_len=64)
    _check_logits(cfg, jl, tl, "prefill")
    for step in range(11):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        tl, cache = model.decode_step(params, cache, torch.from_numpy(nxt))
        _check_logits(cfg, jl, tl, f"decode step {step}")
    assert cache["len"].tolist() == [48, 48]
    for jlc, tlc in zip(jcache["layers"], cache["layers"]):
        assert set(tlc) == {"k", "v", "conv", "ssd"}
        for name, x in tlc.items():
            want = np.asarray(jlc[name], np.float32)
            assert tuple(x.shape) == want.shape, name
            np.testing.assert_allclose(x.float().numpy(), want, rtol=0,
                                       atol=_REL * np.abs(want).max(),
                                       err_msg=name)


def test_prefill_ring_cache_holds_the_last_window(pair):
    """Layer 1's ring after a prompt of 13: positions 5..12 at slot
    position % 8, as a model whose layers are all global holds them in
    order; layer 0 (global) holds all 13 and zeros past them."""
    *_, cfg, model, params, _ = pair
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 13)).astype(np.int32))
    _, cache = model.prefill(params, toks, max_len=16)
    linear = build_model(dataclasses.replace(cfg, global_layers=(0, 1)),
                         device="cpu")
    _, full = linear.prefill(params, toks, max_len=16)
    glob, ring = cache["layers"]
    assert glob["k"].shape[1] == 16 and ring["k"].shape[1] == 8
    assert torch.equal(glob["k"], full["layers"][0]["k"])
    assert not glob["k"][:, 13:].any()
    for name in ("k", "v"):
        for pos in range(5, 13):
            assert torch.equal(ring[name][:, pos % 8],
                               full["layers"][1][name][:, pos])
    specs = model.cache_specs(1, 16)["layers"]
    for lc, spec in zip(cache["layers"], specs):
        assert {k: (tuple(v.shape), v.dtype) for k, v in lc.items()} == spec


def test_prefill_then_decode_equals_a_longer_prefill(pair):
    """Prefill 12 tokens (past the window of 8), decode 2 more, against a
    prefill of all 14."""
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
    wrapper = scan_ops.ssd_scan
    monkeypatch.setattr(scan_ops, "ssd_scan",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    jeng = JaxEngine(jmodel, JaxServeConfig(n_slots=2, max_len=32,
                                            eos_token=-1))
    eng = InferenceEngine(model, ServeConfig(n_slots=2, max_len=32,
                                             eos_token=-1))
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=6))
        eng.submit(Request(rid=i, prompt=p.copy(), max_new_tokens=6))
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
