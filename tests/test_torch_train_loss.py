"""The port's ``LanguageModel.train_loss`` and its gradients against the
JAX package's ``jax.value_and_grad(model.train_loss)``, on the CPU, for
every arch in ``configs`` at ``reduced_config`` (``d_head`` 64, the
attention kernels' smallest; RWKV-6 at width 128 with 2 heads of 64, the
WKV6 kernel's head size), the JAX package's parameters carried across by
``models.convert`` and the same numpy batch (tokens, and patch or source
embeddings where the family takes them) through both.

- The loss within 1e-3 relative.
- Every leaf's gradient within ``_REL_L2`` (8%) of JAX's in relative L2:
  both packages compute every layer in bfloat16 and round at other places
  (the measured worst leaf is 1-5%).  Hymba's per-head SSM vectors
  (``dt_bias``, ``d_skip``) are held at ``_REL_L2_SSM_HEAD`` (25%): their
  gradients sum, over every token, terms that cancel about 40-fold
  (|sum| 0.0015 against sum |.| 0.060 in a layer) and that each package
  rounds to bfloat16 elsewhere; in float32 the port's SSD scan's
  gradients equal the JAX chunked scan's within 4e-7.
- The mixtures of experts route discretely: the test records each MoE
  layer's kept (token, expert) pairs in both packages (JAX's forward
  eager, under ``jax.disable_jit``) and compares the gradients where they
  agree in every layer; a flipped pair is allowed only at a JAX near tie,
  by ``test_torch_lm_families.py``'s rule (helpers copied here).
- ``remat=True`` (layer bodies recomputed in the backward) gives the same
  loss and gradients, bit for bit, as ``remat=False``.
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
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models import build_model
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.train.train_state import loss_and_grads

_REL_L2 = 0.08
_REL_L2_SSM_HEAD = 0.25
_SSM_HEAD = ("['ssm']['dt_bias']", "['ssm']['d_skip']")
_B, _S, _SRC = 2, 16, 9
_ROUTE_LOGIT_GAP = 0.0625      # test_torch_lm_families.py's near-tie rule
_ROUTE_GATE_GAP = 0.02


def _kept(gates: np.ndarray, cap: int) -> np.ndarray:
    """[T,E] gates -> [T,E] bool: the pairs an expert keeps, its top
    ``cap`` tokens by gate (the lower token first on ties) with gate > 0."""
    kept = np.zeros(gates.shape, bool)
    for e, col in enumerate(gates.T):
        top = np.argsort(-col, kind="stable")[:cap]
        kept[top, e] = col[top] > 0
    return kept


def _routing_is_clear(cfg, xf, router, gates, cap) -> bool:
    """No token's k-th router logit within ``_ROUTE_LOGIT_GAP`` of its
    (k+1)-th, and no over-full expert's C-th gate within
    ``_ROUTE_GATE_GAP`` of its (C+1)-th."""
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


def _over(arch):
    if arch.startswith("rwkv6"):
        return dict(d_model=128, n_heads=2, n_kv_heads=2, d_head=64)
    return dict(d_head=64)


def _setup(arch, remat=False):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               **_over(arch))
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              **_over(arch))
    jmodel = jax_build_model(jcfg, remat=False)
    np_params = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    model = build_model(cfg, device="cpu", remat=remat)
    return (jmodel, np_params, model,
            lm_params_from_numpy(cfg, np_params, device="cpu"))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (_B, _S))
           .astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = (0.1 * rng.standard_normal(
            (_B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec:
        out["src_embeds"] = (0.1 * rng.standard_normal(
            (_B, _SRC, cfg.d_model))).astype(np.float32)
    return out


def batch_tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _routes(monkeypatch, jmodel, np_params, model, params, batch):
    """Kept pairs of every MoE layer in each package's forward, and whether
    JAX's routing is clear of ties."""
    jax_calls, port_calls = [], []
    jax_apply, port_apply = jax_moe.moe_apply, port_moe.moe_apply

    def jax_spy(c, p, x, capacity_factor=2.0):
        xf = x.reshape(-1, x.shape[-1])
        gates = np.asarray(jax_moe._route(c, xf, p["router"]))
        cap = min(jax_moe._capacity(c, xf.shape[0], capacity_factor),
                  xf.shape[0])
        jax_calls.append((_kept(gates, cap), _routing_is_clear(
            c, xf, p["router"], gates, cap)))
        return jax_apply(c, p, x, capacity_factor)

    def port_spy(c, p, x, capacity_factor=2.0, counts=None):
        xf = x.reshape(-1, x.shape[-1])
        gates = port_moe._route(c, xf, p["router"]).detach().numpy()
        cap = min(port_moe._capacity(c, xf.shape[0], capacity_factor),
                  xf.shape[0])
        port_calls.append(_kept(gates, cap))
        return port_apply(c, p, x, capacity_factor, counts)

    monkeypatch.setattr(jax_moe, "moe_apply", jax_spy)
    monkeypatch.setattr(port_moe, "moe_apply", port_spy)
    with jax.disable_jit():
        jmodel.train_loss(jax.tree_util.tree_map(jnp.asarray, np_params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        model.train_loss(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    monkeypatch.undo()
    return jax_calls, port_calls


@pytest.mark.parametrize("arch", list_archs())
def test_train_loss_and_grads_match_jax(arch, monkeypatch):
    jmodel, np_params, model, params = _setup(arch)
    batch = _batch(model.cfg)
    if model.cfg.n_experts:
        jax_calls, port_calls = _routes(monkeypatch, jmodel, np_params,
                                        model, params, batch)
        assert len(jax_calls) == len(port_calls) == model.cfg.n_layers
        same = [np.array_equal(jk, pk)
                for (jk, _), pk in zip(jax_calls, port_calls)]
        if not all(same):     # a flip only where JAX's routing is near a tie
            assert not all(clear for (_, clear), eq
                           in zip(jax_calls, same) if not eq)
            return            # gradients of two routings: not comparable
    jl, jg = jax.value_and_grad(jmodel.train_loss)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(model, params, batch_tensors(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-3)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(grads)))
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jg))
    assert len(got) == len(want)
    for path, w in want:
        g = got[path]
        assert g.shape == w.shape and g.dtype == np.float32, path
        key = jax.tree_util.keystr(path)
        tol = _REL_L2_SSM_HEAD if key.endswith(_SSM_HEAD) else _REL_L2
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= tol, (key, rel)


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma2-2b",
                                  "seamless-m4t-large-v2", "pixtral-12b"])
def test_remat_gives_the_same_loss_and_grads_bitwise(arch):
    _, _, model, params = _setup(arch)
    remat = build_model(model.cfg, device="cpu", remat=True)
    batch = batch_tensors(_batch(model.cfg, seed=2))
    loss, grads = loss_and_grads(model, params, batch)
    loss_r, grads_r = loss_and_grads(remat, params, batch)
    assert torch.equal(loss, loss_r)
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(grads_r)):
        assert torch.equal(a, b)


def test_embedding_gradient_sums_repeated_tokens_in_order():
    """The embedding's gradient (a stable-sort segment sum, deterministic
    on the card) equals indexing's own backward on the CPU."""
    _, _, model, params = _setup("qwen2.5-14b")
    batch = _batch(model.cfg, seed=3)
    batch["tokens"][:, ::2] = 7              # many repeats of one token
    table = params["embed"].detach().requires_grad_()
    h = model._embed(dict(params, embed=table), torch.from_numpy(
        batch["tokens"]))
    cot = torch.randn(h.shape, generator=torch.Generator().manual_seed(0))
    (h.float() * cot).sum().backward()
    plain = params["embed"].detach().requires_grad_()
    ((plain[torch.from_numpy(batch["tokens"]).long()]
      * model.cfg.embed_scale).to(torch.bfloat16).float() * cot).sum() \
        .backward()
    assert "EmbeddingLookup" in type(h.grad_fn.next_functions[0][0]
                                     .next_functions[0][0]).__name__
    torch.testing.assert_close(table.grad, plain.grad, rtol=1e-6, atol=0)
