"""The port's flash VJP (``models.attention.FlashAttention``: the flash
kernel's forward with its log-sum-exp, the plain-torch port of the JAX
package's ``_flash_bwd``) against the JAX package, on the CPU.

Inputs are float32 numpy arrays from a seed, fed to both packages:

- gradients against ``jax.grad`` of ``repro.models.attention.
  full_attention(use_flash_vjp=True)`` within atol 2e-5 / rtol 1e-5 (both
  compute in float32; the measured gap is ~2e-6), over the four cases of
  ``tests/test_flash_vjp.py`` (window, soft cap, both), GQA with 5 query
  heads a KV head, bidirectional, cross-attention with S != T, and a
  ``block_size`` under T (the last key block cut short);
- against autograd through the port's plain version (``ref.py``), the
  JAX test's 3e-4 / 1e-3;
- ``ref.py``'s lse against the JAX blockwise forward's (``_attn_fwd_impl``)
  within 1e-5, and -1e30 on rows that see no key;
- the forward with and without the VJP bitwise equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import attention as jax_attention
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     attention_with_lse_ref)
from repro_torch.models.attention import (FlashAttention,
                                          flash_attention_bwd,
                                          full_attention)

_ATOL, _RTOL = 2e-5, 1e-5
# (b, s, t, h, kv, d, mask_kind, window, cap, block_size)
_CASES = [
    (2, 96, 96, 4, 2, 64, "window", 0, 0.0, 32),
    (1, 64, 64, 4, 4, 64, "window", 16, 0.0, 32),
    (1, 80, 80, 2, 1, 64, "window", 0, 20.0, 32),
    (2, 64, 64, 4, 2, 64, "window", 24, 20.0, 32),
    (1, 40, 40, 10, 2, 64, "causal", 0, 0.0, 512),      # GQA 5
    (2, 48, 48, 4, 2, 128, "bidir", 0, 0.0, 512),
    (2, 24, 56, 4, 2, 64, "cross", 0, 30.0, 512),       # S != T
    (1, 70, 70, 4, 1, 64, "causal", 0, 0.0, 32),        # blocks 32, 32, 6
]
_IDS = ["window0", "window16", "cap20", "window24_cap20", "gqa5", "bidir",
        "cross", "ragged_blocks"]


def _configs(cap):
    return (dataclasses.replace(jax_reduced_config(
                jax_get_config("qwen2.5-14b")), attn_softcap=cap),
            dataclasses.replace(reduced_config(get_config("qwen2.5-14b")),
                                attn_softcap=cap))


def _inputs(seed, b, s, t, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32))


def _port_grads(cfg, q, k, v, cot, **kw):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = full_attention(cfg, tq, tk, tv, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_flash_vjp_matches_jax_custom_vjp(case):
    b, s, t, h, kv, d, kind, window, cap, block = case
    jcfg, cfg = _configs(cap)
    q, k, v, cot = _inputs(s + h, b, s, t, h, kv, d)

    def loss(q, k, v):
        out = jax_attention.full_attention(
            jcfg, q, k, v, mask_kind=kind, window=window, block_size=block,
            use_flash_vjp=True)
        return jnp.sum(out * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    _, got = _port_grads(cfg, q, k, v, cot, mask_kind=kind, window=window,
                         block_size=block)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL,
                                   rtol=_RTOL)


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_flash_vjp_matches_autograd_through_the_plain_version(case):
    b, s, t, h, kv, d, kind, window, cap, block = case
    _, cfg = _configs(cap)
    q, k, v, cot = _inputs(s + 2 * h, b, s, t, h, kv, d)
    _, got = _port_grads(cfg, q, k, v, cot, mask_kind=kind, window=window,
                         block_size=block)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention_ref(tq, tk, tv, causal=kind in ("causal", "window"),
                        window=window, softcap=cap)
    (out * torch.from_numpy(cot)).sum().backward()
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=3e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_ref_lse_matches_jax_blockwise_forward(case):
    b, s, t, h, kv, d, kind, window, cap, block = case
    q, k, v, _ = _inputs(s, b, s, t, h, kv, d)
    causal = kind in ("causal", "window")
    out, lse = attention_with_lse_ref(*(torch.from_numpy(x)
                                        for x in (q, k, v)),
                                      causal=causal, window=window,
                                      softcap=cap)
    jout, jlse = jax_attention._attn_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.float32(window), kind, block, 0, cap)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(b, h, s),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


def test_lse_of_rows_that_see_no_key():
    """Causal with a window and S > T: rows past T + window - 1 see no key;
    their lse is -1e30 in both packages (-1e30 + log l rounds to -1e30)."""
    b, s, t, h, kv, d, window = 1, 40, 8, 2, 1, 64, 4
    q, k, v, _ = _inputs(5, b, s, t, h, kv, d)
    _, lse = attention_with_lse_ref(*(torch.from_numpy(x)
                                      for x in (q, k, v)),
                                    causal=True, window=window)
    _, jlse = jax_attention._attn_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.float32(window),
        "window", 512, 0, 0.0)
    blind = np.arange(s) >= t + window - 1
    assert (lse.numpy()[:, :, blind] == -1e30).all()
    np.testing.assert_array_equal(lse.numpy()[:, :, blind],
                                  np.asarray(jlse).reshape(b, h, s)[
                                      :, :, blind])
    assert np.isfinite(lse.numpy()[:, :, ~blind]).all()


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_forward_identical_with_and_without_vjp(cap):
    _, cfg = _configs(cap)
    q, k, v, _ = _inputs(7, 2, 64, 64, 4, 2, 64)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    a = full_attention(cfg, tq, tk, tv, block_size=32, use_flash_vjp=True)
    b = full_attention(cfg, tq, tk, tv, block_size=32, use_flash_vjp=False)
    assert a.grad_fn is not None and b.grad_fn is not None
    assert "FlashAttention" in type(a.grad_fn).__name__
    assert torch.equal(a, b)
    with torch.no_grad():
        c = full_attention(cfg, tq, tk, tv)
    assert c.grad_fn is None and torch.equal(a.detach(), c)


def test_flash_vjp_launches_one_forward_and_saves_the_lse():
    """The Function's forward goes through ``flash_attention_with_lse``
    (the kernel on the card, ``ref.py`` here) and its backward is
    ``flash_attention_bwd`` on the saved lse."""
    _, cfg = _configs(0.0)
    q, k, v, cot = _inputs(3, 1, 32, 32, 2, 2, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_ops.flash_attention_with_lse(tq, tk, tv, True, 0, 0.0)
    assert torch.equal(out, attention_ref(tq, tk, tv))
    grads = flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(cot),
                                True, 0, 0.0, 512)
    _, via_fn = _port_grads(cfg, q, k, v, cot)
    for a, b in zip(grads, via_fn):
        assert torch.equal(a, b)
    assert FlashAttention.apply(tq, tk, tv, True, 0, 0.0, 512).shape \
        == tq.shape
