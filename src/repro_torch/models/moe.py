"""Top-k routed mixture of experts (Granite 32 experts / top-8, Qwen3 128 /
top-8): the JAX package's ``models/moe.py`` on one device.

Token-choice routing with capacity (GShard): each token's router logits
pick its top-k experts, whose gates are the softmax over those k logits;
each expert then keeps its top-C tokens by gate (C from the capacity
factor), runs its gated MLP on them, and the weighted outputs are summed
per token.  A (token, expert) pair routed but not kept is dropped.

Two places where the port pins down what torch leaves open:

- **Ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` defines no order on ties (on CUDA it varies), and
  an expert's capacity pick meets many ties at gate 0.  Every top-k here is
  a stable descending sort, cut to its first k.
- **Determinism.** JAX's ``out.at[tok].add(...)`` would be ``index_add_``,
  which adds with atomics on CUDA: the bits of a sum would change from run
  to run.  Instead each token's kept expert outputs are summed in
  ascending expert order into float32 zeros, the order of the JAX scatter,
  so two runs on the card are bitwise equal.

The expert products are plain batched matrix products, as in JAX, which
computes them outside any Pallas kernel; they multiply bfloat16 values
exactly in float32 and accumulate in float32 (JAX's
``preferred_element_type=float32``).  The expert-parallel entry points of
the JAX package (``moe_apply_sharded``, ``moe_apply_sharded_a2a``) need a
device mesh and are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["moe_params", "moe_apply", "moe_reference"]


def moe_params(cfg) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(d, e), "wi": dense_init(e, d, f),
         "wg": dense_init(e, d, f), "wo": dense_init(e, f, d)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = dense_init(d, fs)
        p["shared_wg"] = dense_init(d, fs)
        p["shared_wo"] = dense_init(fs, d)
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, the lower
    index first among equal ones."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg, x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """x [T,d] -> dense gate matrix [T,E] float32: softmax over each token's
    top-k logits, zero elsewhere (token-choice routing)."""
    logits = (x @ router_w).float()                      # [T, E]
    vals, idx = _top_k(logits, cfg.experts_per_token)    # [T, k]
    gates = torch.softmax(vals, dim=-1)
    return torch.zeros_like(logits).scatter_(1, idx, gates)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product in float32 of (possibly bfloat16) operands."""
    return torch.bmm(a.float(), b.float())


def _expert_compute(cfg, x: torch.Tensor, gate_slice: torch.Tensor,
                    wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
                    capacity: int, counts: Optional[Dict] = None
                    ) -> torch.Tensor:
    """Capacity-C gather / GEMM / combine for a slice of experts.

    x [T,d]; gate_slice [T,E]; wi/wg [E,d,f]; wo [E,f,d] -> [T,d] float32.
    """
    t, d = x.shape
    c = min(capacity, t)
    vals, tok = _top_k(gate_slice.T, c)                  # [E, C]
    live = vals > 0.0
    xg = x[tok.reshape(-1)].reshape(tok.shape[0], c, d)  # [E, C, d]
    h = _bmm_f32(xg, wi)
    h = h * F.silu(_bmm_f32(xg, wg))
    y = _bmm_f32(h.to(x.dtype), wo)
    y = y * (vals * live)[..., None]                     # [E, C, d]
    # Where token t sits in expert e's pick (-1: not picked); a pick holds
    # distinct tokens, so every entry is written once.
    n_exp = tok.shape[0]
    slot = torch.full((n_exp, t), -1, dtype=torch.long, device=x.device)
    slot.scatter_(1, tok, torch.arange(c, device=x.device)
                  .expand(n_exp, c).contiguous())
    # Only a token's routed experts carry a gate > 0, and a pair picked at
    # gate 0 holds a zero in y.  Sum each token's routed experts in
    # ascending order, as the JAX scatter does.
    routed = torch.sort(_top_k(gate_slice, cfg.experts_per_token)[1],
                        dim=-1).values                   # [T, k] ascending
    rows = torch.arange(t, device=x.device)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(routed.shape[1]):
        s = slot[routed[:, j], rows]
        out = out + torch.where((s >= 0)[:, None],
                                y[routed[:, j], s.clamp(min=0)], 0.0)
    if counts is not None:
        n_routed = (gate_slice > 0).sum()
        counts["routed"] = counts.get("routed", 0) + n_routed
        counts["dropped"] = counts.get("dropped", 0) + n_routed - live.sum()
    return out


def _capacity(cfg, tokens: int, capacity_factor: float) -> int:
    per = tokens * cfg.experts_per_token / max(cfg.n_experts, 1)
    return max(1, int(per * capacity_factor + 0.999))


def _shared(cfg, p, x):
    h = x @ p["shared_wi"]
    h = F.silu(x @ p["shared_wg"]) * h
    return h @ p["shared_wo"]


def moe_apply(cfg, p: Dict, x: torch.Tensor, capacity_factor: float = 2.0,
              counts: Optional[Dict] = None) -> torch.Tensor:
    """x [B,S,d] -> [B,S,d] in x's dtype.  ``counts``, where given, gains
    device tensors ``routed`` and ``dropped``: the (token, expert) pairs
    routed and those dropped by capacity."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates = _route(cfg, xf, p["router"])
    cap = _capacity(cfg, xf.shape[0], capacity_factor)
    out = _expert_compute(cfg, xf, gates, p["wi"], p["wg"], p["wo"], cap,
                          counts)
    out = out.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out


def moe_reference(cfg, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Exact (no-capacity) oracle: y_t = sum_e g_te FFN_e(x_t)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates = _route(cfg, xf, p["router"])                 # [T, E]
    h = torch.einsum("td,edf->tef", xf, p["wi"])
    h = h * F.silu(torch.einsum("td,edf->tef", xf, p["wg"]))
    y = torch.einsum("tef,efd->ted", h, p["wo"])
    out = torch.einsum("te,ted->td", gates, y.float())
    out = out.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, p, x)
    return out
