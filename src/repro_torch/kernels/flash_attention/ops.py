"""Wrapper for the flash-attention kernel.

A CUDA tensor launches the hand-written kernel (``flash_attention.py``) or
raises; a CPU tensor takes the plain version (``ref.py``), the counterpart
of the JAX package running its Pallas kernel with ``interpret=True``.  There
is no fallback from one to the other.  ``launches`` counts kernel launches
(and nothing else), so a run can show that it went through the kernel.

A ``meta`` tensor is evaluated abstractly: the call returns empty outputs
of the right shapes and dtypes and reports its analytic work to
``kernels.cost`` (the dry-run's cost counter); any other device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import cost
from .ref import attention_ref, attention_with_lse_ref

__all__ = ["flash_attention", "flash_attention_with_lse", "launches"]

launches = 0

_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be [B,T,KV,D] for q "
                         f"{tuple(q.shape)}")
    t, kv = k.shape[1], k.shape[2]
    if min(b, s, h, t, kv) < 1 or h % kv:
        raise ValueError(f"flash_attention: need B, S, T >= 1 and H ({h}) "
                         f"a multiple of KV ({kv})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window ({window}) and softcap "
                         f"({softcap}) must be >= 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B,S,H,D]; k,v [B,T,KV,D] (H = KV*G) -> out [B,S,H,D] in q's dtype.

    ``window > 0`` restricts causal attention to the last ``window``
    positions; 0 means unrestricted.  ``causal=False`` is bidirectional.
    """
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type == "meta":
        return _abstract(q, k, v, causal, window, with_lse=False)[0]
    return _launch(q, k, v, causal, window, softcap, with_lse=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             window: int = 0, softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s output and each row's log-sum-exp, float32
    [B,H,S] (the JAX package's [B,KV,G,S] read flat), which the attention
    backward needs.  One kernel launch, as ``flash_attention``."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return attention_with_lse_ref(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    if q.device.type == "meta":
        return _abstract(q, k, v, causal, window, with_lse=True)
    return _launch(q, k, v, causal, window, softcap, with_lse=True)


def _abstract(q, k, v, causal, window, with_lse):
    """The meta route: empty outputs and the call's work reported."""
    b, s, h, _ = q.shape
    work = cost.flash_cost(q, k, v, causal, window, with_lse)
    cost.report("flash_attention", work["ops"], work["bytes"])
    lse = torch.empty((b, h, s), dtype=torch.float32, device="meta") \
        if with_lse else None
    return torch.empty_like(q), lse


def _launch(q, k, v, causal, window, softcap, with_lse):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention: the CUDA kernel has no "
                           "backward; under a gradient go through "
                           "models.attention.full_attention (the flash VJP)")
    from .flash_attention import flash_attention_cuda
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    flash_attention_cuda(q, k, v, out, causal, window, softcap, lse)
    launches += 1
    return out, lse
