"""Selective SSM (Mamba-2 SSD) heads of the Hymba hybrid blocks (the JAX
package's ``models/ssm.py``, inference).

Recurrence per head h, state n, channel p:
    h_t = exp(dt_t * a_h) * h_{t-1} + dt_t * B_t[n] * x_t[p]
    y_t = C_t . h_t + D_h * x_t
with a_h = -exp(A_log_h) < 0 and dt = softplus(x W_dt + bias).

A prefill (no state given, any length, one token included) goes through
the SSD kernel wrapper (``kernels/ssd_scan``): the hand-written CUDA kernel
on the card, its plain version on the CPU.  Under a gradient it goes
through :class:`SSDScan`, whose forward is that same wrapper call and whose
backward differentiates the plain chunked form (the JAX package trains
through its chunked form too: the Pallas kernel has no backward).  A decode
step (a state given) runs the recurrence step in plain torch (the JAX
decode runs no kernel either: its chunked form at chunk 1).  Unlike the
JAX package's ``ssd_chunked``, whose unclamped exponents overflow to NaN
once a chunk is long enough, every version here stays finite at any
length.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as scan_ops
from ..kernels.ssd_scan.ref import ssd_chunked_ref, ssd_scan_ref
from .layers import dense_init, rms_norm, scan_vjp

__all__ = ["ssm_params", "ssm_apply", "ssm_state_specs", "SSDScan"]

_CONV_K = 4


def _dims(cfg) -> Tuple[int, int, int]:
    """(inner width, state size, SSM heads of size ``d_head``)."""
    inner = cfg.ssm_expand * cfg.d_model
    return inner, cfg.ssm_state, inner // cfg.d_head


def ssm_params(cfg) -> Dict:
    d = cfg.d_model
    inner, n, heads = _dims(cfg)
    return {
        "w_in": dense_init((d, "embed"), (2 * inner + 2 * n, "heads")),
        "conv": dense_init((_CONV_K, None), (inner + 2 * n, "heads"),
                           scale=1.0 / math.sqrt(_CONV_K)),
        "w_dt": dense_init((d, "embed"), (heads, None)),
        "dt_bias": dense_init((heads, None), init="zeros"),
        "a_log": dense_init((heads, None), init="zeros"),
        "d_skip": dense_init((heads, None), init="ones"),
        "norm": dense_init((inner, None), init="zeros"),
        "w_out": dense_init((inner, "heads"), (d, "embed")),
    }


def _causal_conv(xbc: torch.Tensor, kernel: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, k = 4.  xbc [B,S,C]; kernel [k,C]; state
    [B,k-1,C] (the previous inputs) -> (silu(out) [B,S,C], new state)."""
    b, s, c = xbc.shape
    if state is None:
        state = torch.zeros((b, _CONV_K - 1, c), dtype=xbc.dtype,
                            device=xbc.device)
    padded = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(_CONV_K):
        out = out + padded[:, i:i + s] * kernel[i]
    return F.silu(out), padded[:, -(_CONV_K - 1):]


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: the forward is one
    ``scan_ops.ssd_scan`` call (the kernel on the card) and saves its
    inputs; the backward recomputes the plain chunked form
    (``ref.ssd_chunked_ref``) under autograd and differentiates it, inside
    a profiler range named ``ssd_scan_bwd``.  Returns (y, final state);
    either output may go unused (its gradient arrives as None)."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        return scan_ops.ssd_scan(x, dt, a, bmat, cmat)

    @staticmethod
    def backward(ctx, dy, dstate):
        with torch.profiler.record_function("ssd_scan_bwd"):
            return scan_vjp(ssd_chunked_ref, ctx, (dy, dstate))


def ssm_apply(cfg, p: Dict, u: torch.Tensor, state: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """u [B,S,D] -> (y [B,S,D], state {"conv", "ssd"})."""
    inner, n, heads = _dims(cfg)
    xz = u @ p["w_in"]                                     # [B,S,2I+2N]
    x_part, z, b_in, c_in = torch.split(xz, [inner, inner, n, n], dim=-1)
    xbc = torch.cat([x_part, b_in, c_in], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv"],
                                   None if state is None else state["conv"])
    x_part, b_in, c_in = torch.split(xbc, [inner, n, n], dim=-1)
    bsz, s, _ = x_part.shape
    xh = x_part.reshape(bsz, s, heads, cfg.d_head)
    dt = F.softplus(u @ p["w_dt"] + p["dt_bias"])          # [B,S,H]
    a = -torch.exp(p["a_log"].float())
    if state is None and torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, a, b_in, c_in)):
        y, hfinal = SSDScan.apply(xh, dt, a, b_in, c_in)
    elif state is None:
        y, hfinal = scan_ops.ssd_scan(xh, dt, a, b_in, c_in)
    else:
        y, hfinal = ssd_scan_ref(xh, dt, a, b_in, c_in, state["ssd"])
    y = y.to(xh.dtype) + xh * p["d_skip"][:, None]
    y = y.reshape(bsz, s, inner) * F.silu(z)
    y = rms_norm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], {"conv": conv_state, "ssd": hfinal}


def ssm_state_specs(cfg, batch: int) -> Dict:
    """Per-layer decode state: (shape, dtype) pairs."""
    inner, n, heads = _dims(cfg)
    return {"conv": ((batch, _CONV_K - 1, inner + 2 * n), torch.bfloat16),
            "ssd": ((batch, heads, cfg.d_head, n), torch.float32)}
