"""Plain torch versions of the WKV6 kernel.

``wkv6_scan_ref`` is the per-step recurrence of the JAX package's
``wkv6_reference`` (``models/rwkv6.py``), returning the final state too.
CPU tensors take this path; on the card it is the version the CUDA kernel
is held against, and the model's one-token decode step.

``wkv6_chunked_ref`` mirrors the CUDA kernel's chunk-parallel decomposition
(``csrc/rwkv6_scan.cu``) pass for pass, with its chunk length and exponent
rules, so the CPU tests can pin the kernel's algorithm.  It is also the
form the model's gradient differentiates: the backward of ``models.rwkv6``'s
autograd Function recomputes it under autograd."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .rwkv6_scan import CHUNK

__all__ = ["wkv6_scan_ref", "wkv6_chunked_ref"]


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


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three passes from a zero state: r, k, v, w [B,S,H,K];
    u [H,K] -> (y [B,S,H,K] float32, final state [B,H,K,K] float32).

    With lw = max(log(max(w, 1e-38)), -60), every exponent is a direct sum
    of lw over its span (never a difference of running sums):
    (1) per chunk c, L_c = sum_s (k_s exp(sum_{j>s} lw_j))^T v_s and
        total_c = sum_j lw_j;
    (2) S_c = diag(exp(total_c)) S_{c-1} + L_c, keeping the state that
        enters each chunk;
    (3) y_t = sum_{s<t} [sum_k r_tk k_sk exp(sum_{s<j<t} lw_jk)] v_s
        + (sum_k r_tk u_k k_tk) v_t + (r_t exp(sum_{j<t} lw_j)) S_{c-1},
        the pairwise sums running along t for each s."""
    b, s, h, kk = r.shape
    chunk = CHUNK
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s

    def chunks(x, fill):        # [B,S,H,K] -> [B,H,n_chunks,Q,K] float32
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad), value=fill)
        return x.reshape(b, n_chunks, chunk, h, kk).permute(0, 3, 1, 2, 4)

    rc, kc, vc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0)
    lw = chunks(w, 1.0).clamp_min(1e-38).log().clamp_min(-60.0)

    # (1) local pass: suffix sums from the end; the last is the total.
    suf = torch.zeros_like(lw[..., 0, :])
    kdec = torch.empty_like(kc)
    for t in reversed(range(chunk)):
        kdec[..., t, :] = kc[..., t, :] * torch.exp(suf)
        suf = suf + lw[..., t, :]
    local = torch.einsum("bhcsk,bhcsv->bhckv", kdec, vc)

    # (2) state pass.
    enter = torch.empty_like(local)
    st = torch.zeros_like(local[:, :, 0])
    for c in range(n_chunks):
        enter[:, :, c] = st
        st = torch.exp(suf[:, :, c])[..., None] * st + local[:, :, c]

    # (3) outputs: prefix sums, pairwise sums carried along t.
    pre = torch.zeros_like(suf)
    rdec = torch.empty_like(rc)
    att = rc.new_zeros(rc.shape[:-1] + (chunk,))          # [..., t, s]
    d = torch.zeros_like(lw)                              # [..., s, K]
    for t in range(chunk):
        rdec[..., t, :] = rc[..., t, :] * torch.exp(pre)
        pre = pre + lw[..., t, :]
        if t:
            att[..., t, :t] = torch.einsum(
                "bhck,bhcsk->bhcs", rc[..., t, :],
                kc[..., :t, :] * torch.exp(d[..., :t, :]))
            d[..., :t, :] += lw[..., t:t + 1, :]
    bonus = (rc * u.float()[None, :, None, None, :] * kc).sum(-1)
    att = att + torch.diag_embed(bonus)
    y = att @ vc + rdec @ enter
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n_chunks * chunk, h, kk)
    return y[:, :s], st
