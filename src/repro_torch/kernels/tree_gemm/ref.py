"""Plain torch version of the tree-GEMM kernel (same arithmetic as
``repro_torch.ml.hummingbird.predict_ensemble_gemm``, summed not
averaged).  CPU tensors take this path; on the card it is the version the
CUDA kernel is held against, bitwise."""

from __future__ import annotations

import torch

__all__ = ["tree_gemm_ref"]


def tree_gemm_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, d: torch.Tensor, e: torch.Tensor
                  ) -> torch.Tensor:
    """x [N,F]; a [T,F,I]; b [T,I]; c [T,I,L]; d [T,L]; e [T,L,O]
    -> sum over trees, in tree order, of leaf payouts [N, O]."""
    out = None
    for t in range(a.shape[0]):
        gates = (x @ a[t] <= b[t]).to(torch.float32)      # [N, I]
        s = gates @ c[t]                                  # [N, L] exact ints
        match = (s == d[t]).to(torch.float32)             # [N, L] one-hot
        payout = match @ e[t]                             # [N, O]
        out = payout if out is None else out + payout
    return out
