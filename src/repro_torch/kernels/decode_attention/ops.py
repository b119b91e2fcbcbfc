"""Wrapper for the decode-attention kernel.

A CUDA tensor launches the hand-written kernel (``decode_attention.py``) or
raises; a CPU tensor takes the plain version (``ref.py``), the counterpart
of the JAX package running its Pallas kernel with ``interpret=True``.  There
is no fallback from one to the other.  ``launches`` counts wrapper calls
that launched the kernel (and nothing else), so a run can show that it went
through the kernel: one a call, though the C entry point runs two kernels
(the splits of the cache, then their combine).

The split layout comes from the cache's length T alone
(``decode_attention.split_layout``) and the scratch for the splits'
partials from ``torch.empty``: the wrapper reads no length on the host and
never synchronizes, so a call can be captured in a CUDA graph and replayed
with new lengths and cache contents.

A ``meta`` tensor is evaluated abstractly: the call returns empty outputs
of the right shapes and dtypes and reports its analytic work to
``kernels.cost`` (the dry-run's cost counter); any other device raises.
"""

from __future__ import annotations

import torch

from .. import cost
from .ref import decode_attention_ref

__all__ = ["decode_attention", "launches"]

launches = 0

_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor, softcap: float) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be [B,1,H,D] and the "
                         f"caches [B,T,KV,D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    b, _, h, d = q.shape
    if v_cache.shape != k_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    t, kv = k_cache.shape[1], k_cache.shape[2]
    if min(b, h, t, kv) < 1 or h % kv:
        raise ValueError(f"decode_attention: need B, T >= 1 and H ({h}) a "
                         f"multiple of KV ({kv})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in "
                         f"{_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: q and the caches must share one "
                         f"dtype of {_DTYPES}, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if cache_len.dtype != torch.int32 or tuple(cache_len.shape) != (b,):
        raise ValueError(f"decode_attention: cache_len must be int32 [{b}], "
                         f"got {cache_len.dtype} {tuple(cache_len.shape)}")
    tensors = (q, k_cache, v_cache, cache_len)
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"decode_attention: inputs on "
                         f"{[str(x.device) for x in tensors]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("decode_attention: inputs must be contiguous")
    if q.device.type == "cuda" and any(
            x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: the kernel reads 16-byte aligned "
                         "rows; q or a cache starts off that alignment")
    if softcap < 0:
        raise ValueError(f"decode_attention: softcap ({softcap}) must be "
                         f">= 0")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B,1,H,D]; caches [B,T,KV,D]; cache_len [B] int32 -> [B,1,H,D] in
    q's dtype.  Slots at or beyond ``cache_len[b]`` are masked."""
    global launches
    _check(q, k_cache, v_cache, cache_len, softcap)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    softcap=softcap)
    if q.device.type == "meta":
        work = cost.decode_cost(q, k_cache, v_cache)
        cost.report("decode_attention", work["ops"], work["bytes"])
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    from .decode_attention import decode_attention_cuda, scratch_floats
    b, _, h, d = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty(scratch_floats(b, h, d, k_cache.shape[1]),
                          dtype=torch.float32, device=q.device)
    decode_attention_cuda(q, k_cache, v_cache, cache_len, out, softcap,
                          scratch)
    launches += 1
    return out
