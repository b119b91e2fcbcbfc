"""Wrapper for the WKV6 kernel.

A CUDA tensor launches the hand-written kernel (``rwkv6_scan.py``) or
raises; a CPU tensor takes the plain version (``ref.py``), the counterpart
of the JAX package running its Pallas kernel with ``interpret=True``. There
is no fallback from one to the other. The kernel has no backward of its
own: called directly on a CUDA tensor under a gradient the wrapper raises
(see ``_refuse_grad``); the model trains through ``models.rwkv6.WKV6Scan``,
whose forward is this wrapper and whose backward differentiates the plain
chunked form. ``launches`` counts wrapper calls that launched the kernel
(and nothing else), so a run can show that it went through the kernel: one
a call, though the C entry point runs three passes (chunk-local states, the
state pass across chunks, the outputs).

Unlike the TPU kernel, which drops the state at the end of the sequence,
both versions return it: the model's prefill hands it to the decode cache.
Both start from a zero state, as every prefill does; a decode step carries
its state with the plain recurrence (``ref.wkv6_scan_ref``).  The inputs
reach the kernel in their own dtypes: r, k, v and u share one of float32
and bfloat16, which the kernel widens in registers; w, the decay, is
float32, as the model computes it.

A ``meta`` tensor is evaluated abstractly: the call returns empty outputs
of the right shapes and dtypes and reports its analytic work to
``kernels.cost`` (the dry-run's cost counter); any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cost
from .ref import wkv6_scan_ref

__all__ = ["rwkv6_scan", "launches", "HEAD_SIZE"]

launches = 0

HEAD_SIZE = 64          # RWKV-6's head size; the kernel takes no other
_DTYPES = (torch.float32, torch.bfloat16)


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"rwkv6_scan: r, k, v, w must share one [B,S,H,K] "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, s, h, kk = r.shape
    if min(b, s, h) < 1:
        raise ValueError(f"rwkv6_scan: need B, S, H >= 1, got "
                         f"{tuple(r.shape)}")
    if kk != HEAD_SIZE:
        raise ValueError(f"rwkv6_scan: head size {kk}, the kernel takes "
                         f"{HEAD_SIZE}")
    if tuple(u.shape) != (h, kk):
        raise ValueError(f"rwkv6_scan: u must be [{h},{kk}], got "
                         f"{tuple(u.shape)}")
    if state is not None:
        raise ValueError("rwkv6_scan: the kernel starts from a zero state; "
                         "carry a state with ref.wkv6_scan_ref")
    tensors = [r, k, v, w, u]
    if r.dtype not in _DTYPES or w.dtype != torch.float32 \
            or len({r.dtype, k.dtype, v.dtype, u.dtype}) > 1:
        raise ValueError(f"rwkv6_scan: r, k, v, u must share one dtype of "
                         f"{_DTYPES} and w be float32, got "
                         f"{[x.dtype for x in tensors]}")
    if any(x.device != r.device for x in tensors):
        raise ValueError(f"rwkv6_scan: inputs on "
                         f"{[str(x.device) for x in tensors]}")


def _refuse_grad(*tensors: torch.Tensor) -> None:
    """The CUDA kernel has no backward: a direct call's output would carry
    no ``grad_fn`` and training would silently stop the gradient at the
    scan.  So on the card a direct call under a gradient raises (the model
    goes through ``WKV6Scan``, whose forward runs with grad mode off); on the
    CPU autograd differentiates the plain version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("rwkv6_scan: the CUDA kernel has no backward; "
                           "train through models.rwkv6.WKV6Scan, or call "
                           "the kernel under torch.no_grad()")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and on a 16-byte boundary, as the kernel loads 16
    bytes a thread: ``x`` itself where it is both, else a copy."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w [B,S,H,64] (w the per-step decay in (0, 1)); u [H,64];
    r, k, v, u float32 or bfloat16 alike, w float32; ``state`` must be None
    (a zero initial state) -> (y [B,S,H,64] float32, final state
    [B,H,64,64] float32)."""
    global launches
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return wkv6_scan_ref(r, k, v, w, u)
    if r.device.type == "meta":
        work = cost.wkv6_cost(r, k, v, w, u)
        cost.report("rwkv6_scan", work["ops"], work["bytes"])
        b, _, h, kk = r.shape
        return (torch.empty(r.shape, dtype=torch.float32, device="meta"),
                torch.empty((b, h, kk, kk), dtype=torch.float32,
                            device="meta"))
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: no kernel for device {r.device}")
    _refuse_grad(r, k, v, w, u)
    from .rwkv6_scan import rwkv6_scan_cuda, scratch_floats
    r, k, v, w, u = (_aligned(x) for x in (r, k, v, w, u))
    b, s, h, kk = r.shape
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state_out = torch.empty((b, h, kk, kk), dtype=torch.float32,
                            device=r.device)
    scratch = torch.empty(scratch_floats(b, s, h, kk), dtype=torch.float32,
                          device=r.device)
    rwkv6_scan_cuda(r, k, v, w, u, y, state_out, scratch)
    launches += 1
    return y, state_out
