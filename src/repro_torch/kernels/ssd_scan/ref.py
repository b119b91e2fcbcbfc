"""Plain torch versions of the SSD kernel.

``ssd_scan_ref`` is the per-step recurrence of the JAX package's
``ssd_reference`` (``models/ssm.py``), with y kept in float32 as the TPU
kernel writes it.  CPU tensors take this path; on the card it is the
version the CUDA kernel is held against, and the model's one-token decode
step.

``ssd_chunked_ref`` mirrors the CUDA kernel's chunk-parallel decomposition
(``csrc/ssd_scan.cu``) pass for pass, with its chunk length and exponent
rules, so the CPU tests can pin the kernel's algorithm.  It is also the
form the model's gradient differentiates: the backward of ``models.ssm``'s
autograd Function recomputes it under autograd."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .ssd_scan import CHUNK

__all__ = ["ssd_scan_ref", "ssd_chunked_ref"]


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H]; a [H]; bmat, cmat [B,S,N]; h0 [B,H,P,N] or
    None (zeros) -> (y [B,S,H,P] float32, final state [B,H,P,N] float32).

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    hs = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    af = a.float()
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                 # [B,H]
        da = torch.exp(dtt * af[None, :])
        upd = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].float(),
                           bmat[:, t].float())
        hs = hs * da[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cmat[:, t].float(), hs))
    return torch.stack(ys, dim=1), hs


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's three passes from a zero state: x [B,S,H,P]; dt
    [B,S,H]; a [H] (<= 0); bmat, cmat [B,S,N] -> (y [B,S,H,P] float32,
    final state [B,H,P,N] float32).

    With c_t = sum_{j<=t} dt_j a within the chunk (a float64 cumsum of the
    float32 products, each difference rounded to float32), every exponent
    clamped at 0 before exp:
    (1) per chunk c, L_c = sum_s exp(min(c_last - c_s, 0)) dt_s x_s B_s^T
        and c_last;
    (2) h_c = exp(min(c_last, 0)) h_{c-1} + L_c, keeping the state that
        enters each chunk;
    (3) y_t = sum_{s<=t} (C_t . B_s) exp(min(c_t - c_s, 0)) dt_s x_s
        + exp(min(c_t, 0)) h_{c-1} C_t."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = CHUNK
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(
        bsz, n_chunks, chunk, h, p).permute(0, 3, 1, 2, 4)   # [B,H,c,Q,P]
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(
        bsz, n_chunks, chunk, h).permute(0, 3, 1, 2)         # [B,H,c,Q]
    bc, cc = (F.pad(m.float(), (0, 0, 0, pad)).reshape(
        bsz, n_chunks, chunk, n) for m in (bmat, cmat))      # [B,c,Q,N]
    cs = torch.cumsum((dtc * a.float()[None, :, None, None]).double(),
                      dim=-1)
    last = cs[..., -1]                                       # [B,H,c]

    def decay(exponent):        # float64 exponent -> float32 exp(min(., 0))
        return torch.exp(torch.clamp(exponent.float(), max=0.0))

    # (1) local pass.
    rem = decay(last[..., None] - cs) * dtc
    local = torch.einsum("bhcsp,bcsn,bhcs->bhcpn", xc, bc, rem)

    # (2) state pass.
    enter = torch.empty_like(local)
    hs = torch.zeros_like(local[:, :, 0])
    for c in range(n_chunks):
        enter[:, :, c] = hs
        hs = decay(last[:, :, c])[..., None, None] * hs + local[:, :, c]

    # (3) outputs.
    scores = torch.einsum("bctn,bcsn->bcts", cc, bc)[:, None]
    dec = decay(cs[..., :, None] - cs[..., None, :])
    wmat = torch.tril(scores * dec * dtc[..., None, :])
    y = wmat @ xc + decay(cs)[..., None] \
        * torch.einsum("bctn,bhcpn->bhctp", cc, enter)
    y = y.permute(0, 2, 3, 1, 4).reshape(bsz, n_chunks * chunk, h, p)
    return y[:, :s], hs
