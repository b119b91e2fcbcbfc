"""The scans' gradients: ``models.rwkv6.WKV6Scan`` and
``models.ssm.SSDScan`` (forward the kernel wrapper, here its plain
version on the CPU; backward the plain chunked form under autograd)
against the JAX package's gradient, which is autodiff of its chunked scans
(``wkv6_chunked``, ``ssd_chunked``: the Pallas kernels have no backward).

- Float32, the same numpy inputs and cotangents (for y and the final
  state) through both: every input's gradient within 1e-5 relative L2 of
  ``jax.vjp``'s (for SSD, where JAX's own gradient is farther than that
  from the float64 recurrence's, at least as close to it as JAX's).
  Hymba's SSD on short sequences only: the JAX ``ssd_chunked`` overflows
  to NaN on chunks of about 100 steps or more.
- Against autograd through the per-step recurrences of ``ref.py``
  (``wkv6_scan_ref``, ``ssd_scan_ref``): within 1e-6 (or both within
  1e-6 of the float64 recurrence's where the two float32 gradients of a
  cancelling sum differ by more).
- An output left unused (its gradient None) and the model's routing: with
  a gradient the time-mix and the SSM go through the Functions, without
  one through a single wrapper call.
- ``train_loss`` of RWKV-6 and Hymba at ``reduced_config`` through the
  Functions, against ``jax.value_and_grad``, at
  ``tests/test_torch_train_loss.py``'s tolerances.
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
from repro.models.rwkv6 import wkv6_chunked
from repro.models.ssm import ssd_chunked
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.rwkv6_scan.ref import wkv6_scan_ref
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as port_rwkv
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.models.rwkv6 import WKV6Scan
from repro_torch.models.ssm import SSDScan
from repro_torch.train.train_state import loss_and_grads

_JAX_REL = 1e-5
_REF_REL = 1e-6
_REL_L2 = 0.08                 # tests/test_torch_train_loss.py's
_REL_L2_SSM_HEAD = 0.25
_SSM_HEAD = ("['ssm']['dt_bias']", "['ssm']['d_skip']")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _wkv_inputs(seed, b, s, h):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, s, h, 64)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(0.5 * rng.standard_normal((b, s, h, 64)) - 1.0)) \
        .astype(np.float32)
    u = (0.3 * rng.standard_normal((h, 64))).astype(np.float32)
    dy = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    dst = rng.standard_normal((b, h, 64, 64)).astype(np.float32)
    return [r, k, v, w, u], (dy, dst)


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((b, s, h)) - 1.0)) \
        .astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dst = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return [x, dt, a, bm, cm], (dy, dst)


def _jax_vjp(fn, inputs, cots):
    _, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cots))]


def _torch_grads(fn, inputs, cots, use=(True, True)):
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    y, st = fn(*xs)
    loss = 0
    if use[0]:
        loss = loss + (y * torch.from_numpy(cots[0])).sum()
    if use[1]:
        loss = loss + (st * torch.from_numpy(cots[1])).sum()
    loss.backward()
    return [np.zeros(x.shape, np.float32) if x.grad is None
            else x.grad.numpy() for x in xs]


_WKV_CASES = [(2, 37, 2), (1, 64, 3), (2, 16, 1), (1, 5, 2)]
_SSD_CASES = [(2, 37, 2, 64, 16), (1, 64, 3, 32, 8), (2, 16, 1, 64, 4),
              (1, 1, 2, 16, 16)]


@pytest.mark.parametrize("b,s,h", _WKV_CASES)
def test_wkv6_function_matches_jax_chunked_gradient(b, s, h):
    inputs, cots = _wkv_inputs(s, b, s, h)
    want = _jax_vjp(lambda *a: wkv6_chunked(*a), inputs, cots)
    got = _torch_grads(WKV6Scan.apply, inputs, cots)
    for name, g, w in zip("rkvwu", got, want):
        assert _rel(g, w) <= _JAX_REL, (name, _rel(g, w))


def _ssd_float64(x, dt, a, bm, cm):
    """The SSD recurrence in float64: the exact gradient's stand-in."""
    b, s, h, p = x.shape
    hs = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(s):
        hs = hs * torch.exp(dt[:, t] * a[None])[:, :, None, None] \
            + torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cm[:, t], hs))
    return torch.stack(ys, 1), hs


def _wkv_float64(r, k, v, w, u):
    """The WKV6 recurrence in float64."""
    b, s, h, kk = r.shape
    st = torch.zeros((b, h, kk, kk), dtype=torch.float64)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               st + u[None, :, :, None] * kv))
        st = st * w[:, t, :, :, None] + kv
    return torch.stack(ys, 1), st


@pytest.mark.parametrize("b,s,h,p,n", _SSD_CASES)
def test_ssd_function_matches_jax_chunked_gradient(b, s, h, p, n):
    """Within 1e-5 of JAX's, except where JAX's own float32 gradient is
    farther than that from the float64 recurrence's: ``a``'s gradient, one
    number a head, sums terms over every step and channel that cancel, and
    with one head both packages land ~1e-5 off the exact value (measured:
    the port 7.8e-6, JAX 1.4e-5).  There the port must be at least as
    close to the exact gradient as JAX is."""
    inputs, cots = _ssd_inputs(s, b, s, h, p, n)
    want = _jax_vjp(lambda *a: ssd_chunked(*a), inputs, cots)
    got = _torch_grads(SSDScan.apply, inputs, cots)
    exact = _torch_grads(
        lambda *a: _ssd_float64(*a),
        [x.astype(np.float64) for x in inputs],
        [c.astype(np.float64) for c in cots])
    for name, g, w, e in zip(["x", "dt", "a", "B", "C"], got, want, exact):
        assert np.isfinite(w).all()
        if _rel(w, e) <= _JAX_REL:
            assert _rel(g, w) <= _JAX_REL, (name, _rel(g, w))
        else:
            assert _rel(g, e) <= _rel(w, e), (name, _rel(g, e), _rel(w, e))


@pytest.mark.parametrize("use", [(True, True), (True, False),
                                 (False, True)])
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_function_matches_autograd_through_the_recurrence(scan, use):
    """Each output used alone or both: the Function's gradients (its
    backward receives None for an unused output) within 1e-6 of autograd
    through the per-step recurrence of ``ref.py``.  Two float32 gradients
    of a sum that cancels can differ by more than each differs from the
    exact value (SSD's ``a`` with y alone: 1.04e-6 apart, 7.0e-7 and
    4.1e-7 from the float64 recurrence's); there both must be within 1e-6
    of the float64 recurrence's gradient."""
    if scan == "wkv6":
        inputs, cots = _wkv_inputs(7, 2, 45, 2)
        fn, ref, exact_fn = WKV6Scan.apply, wkv6_scan_ref, _wkv_float64
    else:
        inputs, cots = _ssd_inputs(7, 2, 150, 2, 64, 16)
        fn, ref, exact_fn = SSDScan.apply, ssd_scan_ref, _ssd_float64
    got = _torch_grads(fn, inputs, cots, use)
    want = _torch_grads(ref, inputs, cots, use)
    exact = _torch_grads(exact_fn, [x.astype(np.float64) for x in inputs],
                         [c.astype(np.float64) for c in cots], use)
    for g, w, e in zip(got, want, exact):
        if _rel(g, w) > _REF_REL:
            assert max(_rel(g, e), _rel(w, e)) <= _REF_REL, \
                (_rel(g, w), _rel(g, e), _rel(w, e))


def test_function_forward_is_one_wrapper_call_and_equals_it(monkeypatch):
    """The Functions' forward is the wrapper's output itself (bitwise),
    from one call of it, and their backward is a profiler range."""
    calls = []
    inputs, _ = _wkv_inputs(3, 1, 20, 2)
    real = port_rwkv.scan_ops.rwkv6_scan

    def spy(*a):
        calls.append(torch.is_grad_enabled())
        return real(*a)
    monkeypatch.setattr(port_rwkv.scan_ops, "rwkv6_scan", spy)
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    y, st = WKV6Scan.apply(*xs)
    assert calls == [False]
    want = wkv6_scan_ref(*[torch.from_numpy(x) for x in inputs])
    assert torch.equal(y.detach(), want[0])
    assert torch.equal(st.detach(), want[1])
    with torch.profiler.profile() as prof:
        y.sum().backward()
    assert "rwkv6_scan_bwd" in {e.name for e in prof.events()}


def _cfg(arch):
    over = dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64) \
        if arch.startswith("rwkv6") else dict(d_head=64)
    return dataclasses.replace(reduced_config(get_config(arch)), **over), \
        dataclasses.replace(jax_reduced_config(jax_get_config(arch)), **over)


@pytest.mark.parametrize("grad", [True, False])
def test_model_routes_through_the_functions_only_under_a_gradient(grad):
    torch.manual_seed(0)
    rcfg, _ = _cfg("rwkv6-1.6b")
    hcfg, _ = _cfg("hymba-1.5b")
    x = torch.randn(2, 9, 128)
    rp = {k: v for k, v in build_model(rcfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))["layers"][0].items()}
    tm = {k[3:]: v.requires_grad_() for k, v in rp.items()
          if k.startswith("tm_")}
    sp = {k: v.requires_grad_() for k, v in build_model(
        hcfg, device="cpu").init_params(torch.Generator().manual_seed(1))
        ["layers"][0]["ssm"].items()}
    with torch.set_grad_enabled(grad):
        y, _ = port_rwkv.rwkv_time_mix(rcfg, tm, x)
        ys, _ = port_ssm.ssm_apply(hcfg, sp, torch.randn(2, 9, hcfg.d_model))
    names = []
    for out in (y, ys):
        stack, seen = [out.grad_fn], set()
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            names.append(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    assert any("WKV6Scan" in n for n in names) == grad
    assert any("SSDScan" in n for n in names) == grad
    if grad:           # a_log's gradient flows back through a = -exp(a_log)
        ys.float().sum().backward()
        assert sp["a_log"].grad is not None
        assert float(sp["a_log"].grad.abs().sum()) > 0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_train_loss_through_the_functions_matches_jax(arch, monkeypatch):
    cfg, jcfg = _cfg(arch)
    jmodel = jax_build_model(jcfg, remat=False)
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu", remat=True)
    params = lm_params_from_numpy(cfg, np_params, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))
             .astype(np.int32)}
    fn = WKV6Scan if cfg.rwkv else SSDScan
    calls = []
    real = fn.forward

    def counted(ctx, *a):
        calls.append(1)
        return real(ctx, *a)
    monkeypatch.setattr(fn, "forward", staticmethod(counted))
    jl, jg = jax.value_and_grad(jmodel.train_loss)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(model, params, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(calls) == 2 * cfg.n_layers        # remat runs each twice
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(grads)))
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, jg)):
        key = jax.tree_util.keystr(path)
        tol = _REL_L2_SSM_HEAD if key.endswith(_SSM_HEAD) else _REL_L2
        assert _rel(got[path], w) <= tol, (key, _rel(got[path], w))
