"""Wrapper for the SSD kernel.

A CUDA tensor launches the hand-written kernel (``ssd_scan.py``) or raises;
a CPU tensor takes the plain version (``ref.py``), the counterpart of the
JAX package running its Pallas kernel with ``interpret=True``. There is no
fallback from one to the other. The kernel has no backward of its own:
called directly on a CUDA tensor under a gradient the wrapper raises (see
``_refuse_grad``); the model trains through ``models.ssm.SSDScan``, whose
forward is this wrapper and whose backward differentiates the plain chunked
form. ``launches`` counts wrapper calls that launched the kernel (and
nothing else), so a run can show that it went through the kernel: one a
call, though the C entry point runs three passes (chunk-local states, the
state pass across chunks, the outputs).

Unlike the TPU kernel, which drops the state at the end of the sequence,
both versions return it: the model's prefill hands it to the decode cache.
Both start from a zero state, as every prefill does; a decode step carries
its state with the plain recurrence (``ref.ssd_scan_ref``).  The inputs
reach the kernel in their own dtypes: x, dt, bmat and cmat share one of
float32 and bfloat16, which the kernel widens in registers; the decay rate
a is float32, as the model computes it.  x, bmat and cmat may be views into
one wider per-token row, as the model splits them, and are not copied.
``a`` must be <= 0 (the model's a = -exp(a_log)); the wrapper does not
check it, since that would read the card.

A ``meta`` tensor is evaluated abstractly: the call returns empty outputs
of the right shapes and dtypes and reports its analytic work to
``kernels.cost`` (the dry-run's cost counter); any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cost
from .ref import ssd_scan_ref

__all__ = ["ssd_scan", "launches", "MAX_HEAD_DIM", "MAX_STATE"]

launches = 0

MAX_HEAD_DIM = 64       # P: channels per head the kernel takes
MAX_STATE = 16          # N: state size the kernel takes
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, dt, a, bmat, cmat, h0) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be [B,S,H,P], got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    if min(b, s, h) < 1:
        raise ValueError(f"ssd_scan: need B, S, H >= 1, got "
                         f"{tuple(x.shape)}")
    if tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,):
        raise ValueError(f"ssd_scan: dt must be [{b},{s},{h}] and a [{h}], "
                         f"got {tuple(dt.shape)}, {tuple(a.shape)}")
    if bmat.dim() != 3 or tuple(bmat.shape[:2]) != (b, s) \
            or cmat.shape != bmat.shape:
        raise ValueError(f"ssd_scan: bmat and cmat must share one "
                         f"[{b},{s},N] shape, got {tuple(bmat.shape)}, "
                         f"{tuple(cmat.shape)}")
    n = bmat.shape[2]
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"ssd_scan: head dim {p} and state {n}, the kernel "
                         f"takes 1..{MAX_HEAD_DIM} and 1..{MAX_STATE}")
    if h0 is not None:
        raise ValueError("ssd_scan: the kernel starts from a zero state; "
                         "carry a state with ref.ssd_scan_ref")
    tensors = [x, dt, a, bmat, cmat]
    if x.dtype not in _DTYPES or a.dtype != torch.float32 \
            or len({x.dtype, dt.dtype, bmat.dtype, cmat.dtype}) > 1:
        raise ValueError(f"ssd_scan: x, dt, bmat, cmat must share one dtype "
                         f"of {_DTYPES} and a be float32, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd_scan: inputs on "
                         f"{[str(t.device) for t in tensors]}")


def _refuse_grad(*tensors: torch.Tensor) -> None:
    """The CUDA kernel has no backward: a direct call's output would carry
    no ``grad_fn`` and training would silently stop the gradient at the
    scan.  So on the card a direct call under a gradient raises (the model
    goes through ``SSDScan``, whose forward runs with grad mode off); on the
    CPU autograd differentiates the plain version."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("ssd_scan: the CUDA kernel has no backward; train "
                           "through models.ssm.SSDScan, or call the "
                           "kernel under torch.no_grad()")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B,S,...] as the kernel reads it: contiguous within a token,
    one row stride from token to token across batch rows (a view into a
    wider row passes as it is; anything else is copied)."""
    rows_even = t.shape[0] == 1 or t.stride(0) == t.shape[1] * t.stride(1)
    if t[0, 0].is_contiguous() and rows_even \
            and t.stride(1) >= t[0, 0].numel():
        return t
    return t.contiguous()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P] (P <= 64); dt [B,S,H]; a [H] (<= 0); bmat, cmat [B,S,N]
    (N <= 16), shared by the heads; x, dt, bmat, cmat float32 or bfloat16
    alike, a float32; ``h0`` must be None (a zero initial state) ->
    (y [B,S,H,P] float32, final state [B,H,P,N] float32)."""
    global launches
    _check(x, dt, a, bmat, cmat, h0)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, bmat, cmat)
    if x.device.type == "meta":
        work = cost.ssd_cost(x, dt, a, bmat, cmat)
        cost.report("ssd_scan", work["ops"], work["bytes"])
        b, _, h, p = x.shape
        return (torch.empty(x.shape, dtype=torch.float32, device="meta"),
                torch.empty((b, h, p, bmat.shape[2]), dtype=torch.float32,
                            device="meta"))
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    _refuse_grad(x, dt, a, bmat, cmat)
    from .ssd_scan import scratch_floats, ssd_scan_cuda
    x, bmat, cmat = _rows(x), _rows(bmat), _rows(cmat)
    dt, a = dt.contiguous(), a.contiguous()
    b, s, h, p = x.shape
    n = bmat.shape[2]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    h_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(scratch_floats(b, s, h, p, n), dtype=torch.float32,
                          device=x.device)
    ssd_scan_cuda(x, dt, a, bmat, cmat, y, h_out, scratch)
    launches += 1
    return y, h_out
