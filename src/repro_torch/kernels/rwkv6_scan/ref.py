"""Plain torch version of the WKV6 kernel: the per-step recurrence of the
JAX package's ``wkv6_reference`` (``models/rwkv6.py``), returning the final
state too.  CPU tensors take this path; on the card it is the version the
CUDA kernel is held against, and the model's one-token decode step."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["wkv6_scan_ref"]


def wkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w [B,S,H,K] (w the decay in (0, 1)); u [H,K]; state
    [B,H,K,K] or None (zeros) -> (y [B,S,H,K] float32, final state
    [B,H,K,K] float32).

    y_t = r_t (S + diag(u) k_t^T v_t);  S <- diag(w_t) S + k_t^T v_t."""
    b, s, h, kk = r.shape
    st = torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(s):
        kt, vt, rt = k[:, t].float(), v[:, t].float(), r[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]              # [B,H,K,V]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, st + uf * kv))
        st = st * w[:, t].float()[..., None] + kv
    return torch.stack(ys, dim=1), st
