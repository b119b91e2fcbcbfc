"""Plain torch version of the SSD kernel: the per-step recurrence of the
JAX package's ``ssd_reference`` (``models/ssm.py``), with y kept in float32
as the TPU kernel writes it.  CPU tensors take this path; on the card it is
the version the CUDA kernel is held against, and the model's one-token
decode step."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_scan_ref"]


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
