"""RWKV-6 "Finch" blocks (the JAX package's ``models/rwkv6.py``, inference):
time-mix with data-dependent decay and channel-mix.

Recurrence per head (K = V = head size 64):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S in R^{K x V})
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t in (0, 1) produced per token by the decay LoRA, token-shift
ddlerp mixing, and a squared-ReLU channel-mix.

A prefill (no state given, any length, one token included) goes through
the WKV6 kernel wrapper (``kernels/rwkv6_scan``): the hand-written CUDA
kernel on the card, its plain version on the CPU.  Under a gradient it goes
through :class:`WKV6Scan`, whose forward is that same wrapper call and whose
backward differentiates the plain chunked form (the JAX package trains
through its chunked form too: the Pallas kernel has no backward).  A decode
step (a state given) runs the recurrence step in plain torch (the JAX
decode runs no kernel either: its chunked form at chunk 1).

Mixed dtypes follow the JAX package's promotion: the WKV output is float32,
so everything after it in the block (the output projection, the residual,
the channel-mix) runs in float32 with the bfloat16 weights widened, as JAX
promotes ``f32 @ bf16`` (``torch.matmul`` refuses mixed dtypes, so
:func:`_mm` widens explicitly).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_scan import ops as scan_ops
from ..kernels.rwkv6_scan.ref import wkv6_chunked_ref, wkv6_scan_ref
from .layers import dense_init, rms_norm, scan_vjp

__all__ = ["rwkv_params", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_state_specs", "WKV6Scan"]

_DDLERP_RANK = 32
_DECAY_RANK = 64


def rwkv_params(cfg) -> Dict:
    d = cfg.d_model
    f = cfg.d_ff
    return {
        # time-mix
        "mu_x": dense_init((d, None), init="zeros"),
        "mu_rkvwg": dense_init((5, None), (d, None), init="zeros"),
        "ddlerp_w1": dense_init((d, "embed"), (5 * _DDLERP_RANK, None)),
        "ddlerp_w2": dense_init((5, None), (_DDLERP_RANK, None),
                                (d, "embed")),
        "decay_base": dense_init((d, None), init="zeros", scale=0.0),
        "decay_w1": dense_init((d, "embed"), (_DECAY_RANK, None)),
        "decay_w2": dense_init((_DECAY_RANK, None), (d, "embed")),
        "bonus_u": dense_init((d, None), init="zeros"),
        "wr": dense_init((d, "embed"), (d, "heads")),
        "wk": dense_init((d, "embed"), (d, "heads")),
        "wv": dense_init((d, "embed"), (d, "heads")),
        "wg": dense_init((d, "embed"), (d, "heads")),
        "wo": dense_init((d, "heads"), (d, "embed")),
        "ln_x": dense_init((d, None), init="zeros"),
        # channel-mix
        "cm_mu_k": dense_init((d, None), init="zeros"),
        "cm_mu_r": dense_init((d, None), init="zeros"),
        "cm_wk": dense_init((d, "embed"), (f, "mlp")),
        "cm_wv": dense_init((f, "mlp"), (d, "embed")),
        "cm_wr": dense_init((d, "embed"), (d, "mlp")),
    }


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as JAX computes it."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype) @ b.to(dtype)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x [B,S,D] -> the previous token's x (the first takes ``prev`` or
    zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    dtype = torch.promote_types(prev.dtype, x.dtype)
    return torch.cat([prev.to(dtype), x[:, :-1].to(dtype)], dim=1)


def _ddlerp(p: Dict, x: torch.Tensor, xs: torch.Tensor):
    """Data-dependent lerp producing the 5 mixed inputs (w, k, v, r, g)."""
    dx = xs - x
    base = x + dx * p["mu_x"]
    lora = torch.tanh(_mm(base, p["ddlerp_w1"]))
    b, s, _ = x.shape
    lora = lora.reshape(b, s, 5, _DDLERP_RANK)
    w2 = p["ddlerp_w2"].to(lora.dtype)
    adj = torch.einsum("bsfr,frd->bsfd", lora, w2)
    mixed = x[:, :, None] + dx[:, :, None] * (p["mu_rkvwg"] + adj)
    return [mixed[:, :, i] for i in range(5)]


class WKV6Scan(torch.autograd.Function):
    """The WKV6 scan with a gradient: the forward is one
    ``scan_ops.rwkv6_scan`` call (the kernel on the card) and saves its
    inputs; the backward recomputes the plain chunked form
    (``ref.wkv6_chunked_ref``) under autograd and differentiates it,
    inside a profiler range named ``rwkv6_scan_bwd``.  Returns (y, final
    state); either output may go unused (its gradient arrives as None)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return scan_ops.rwkv6_scan(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy, dstate):
        with torch.profiler.record_function("rwkv6_scan_bwd"):
            return scan_vjp(wkv6_chunked_ref, ctx, (dy, dstate))


def rwkv_time_mix(cfg, p: Dict, x: torch.Tensor,
                  state: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """x [B,S,D] -> (y [B,S,D] float32, state {"tm_shift", "wkv"})."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.d_head
    xs = _token_shift(x, None if state is None else state["tm_shift"])
    xw, xk, xv, xr, xg = _ddlerp(p, x, xs)
    decay_in = p["decay_base"] + _mm(torch.tanh(_mm(xw, p["decay_w1"])),
                                     p["decay_w2"])
    w = torch.exp(-torch.exp(decay_in.float()))          # (0, 1)
    r = _mm(xr, p["wr"]).reshape(b, s, h, hd)
    k = _mm(xk, p["wk"]).reshape(b, s, h, hd)
    v = _mm(xv, p["wv"]).reshape(b, s, h, hd)
    g = F.silu(_mm(xg, p["wg"]))
    u = p["bonus_u"].reshape(h, hd)
    w = w.reshape(b, s, h, hd)
    if state is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        y, wkv = WKV6Scan.apply(r, k, v, w, u)
    elif state is None:
        y, wkv = scan_ops.rwkv6_scan(r, k, v, w, u)
    else:
        y, wkv = wkv6_scan_ref(r, k, v, w, u, state["wkv"])
    y = rms_norm(y.reshape(b, s, d), p["ln_x"], cfg.norm_eps) * g
    return _mm(y, p["wo"]), {"tm_shift": x[:, -1:], "wkv": wkv}


def rwkv_channel_mix(cfg, p: Dict, x: torch.Tensor,
                     state: Optional[Dict] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    xs = _token_shift(x, None if state is None else state["cm_shift"])
    dx = xs - x
    xk = x + dx * p["cm_mu_k"]
    xr = x + dx * p["cm_mu_r"]
    kk = torch.square(F.relu(_mm(xk, p["cm_wk"])))
    out = torch.sigmoid(_mm(xr, p["cm_wr"])) * _mm(kk, p["cm_wv"])
    return out, {"cm_shift": x[:, -1:]}


def rwkv_state_specs(cfg, batch: int) -> Dict:
    """Per-layer decode state: (shape, dtype) pairs."""
    h, hd, d = cfg.n_heads, cfg.d_head, cfg.d_model
    return {"tm_shift": ((batch, 1, d), torch.bfloat16),
            "wkv": ((batch, h, hd, hd), torch.float32),
            "cm_shift": ((batch, 1, d), torch.bfloat16)}
