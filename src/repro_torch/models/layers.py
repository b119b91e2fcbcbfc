"""Shared model components: parameter templates, norms, RoPE, activations
and the gated MLP (the JAX package's ``models/layers.py``).

A template is a nested dict (or list) whose leaves are :class:`ParamDef`;
``init_params`` materializes it with a ``torch.Generator`` under the JAX
package's rule: ``normal`` leaves draw N(0, 1) times ``scale`` (default
1/sqrt(fan_in), fan_in being the second-to-last dim), ``zeros`` and
``ones`` are constant.  Every leaf carries its *logical* axes (``embed``,
``heads``, ``kv``, ``mlp``, ``vocab``, ``expert`` or None per dim), the JAX
package's names; ``distributed.sharding`` maps them onto a mesh's axes.
``abstract_params`` builds the same tree as ``meta`` tensors (shapes and
dtypes, no storage) and ``param_axes`` the tree of axes tuples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ParamDef", "dense_init", "init_params", "abstract_params",
           "param_axes", "rms_norm", "softcap", "rope", "apply_rope",
           "mlp_params", "mlp_apply", "scan_vjp"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis name per dim
    init: str = "normal"                # normal | zeros | ones
    scale: Optional[float] = None       # None => 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDef: shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def dense_init(*shape_axes: Tuple[int, Optional[str]], init: str = "normal",
               scale: Optional[float] = None) -> ParamDef:
    """A template leaf from ``(dim, logical axis)`` pairs."""
    return ParamDef(tuple(s for s, _ in shape_axes),
                    tuple(a for _, a in shape_axes), init, scale)


def _materialize(d: ParamDef, generator: torch.Generator,
                 dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[0] if len(d.shape) == 1 else d.shape[-2]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(
        max(fan_in, 1))
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(device=device, dtype=dtype)


def init_params(template, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None):
    """Materialize a template on ``device`` (default: the generator's);
    normal leaves are drawn in float32 on the generator's device."""
    device = torch.device(device if device is not None
                          else generator.device)
    return _map(template,
                lambda d: _materialize(d, generator, dtype, device))


def _map(template, fn):
    """``fn`` on every leaf, in ``init_params``' structure (dict keys
    sorted, lists in order)."""
    if isinstance(template, ParamDef):
        return fn(template)
    if isinstance(template, dict):
        return {k: _map(template[k], fn) for k in sorted(template)}
    return [_map(x, fn) for x in template]


def abstract_params(template, dtype: torch.dtype = torch.float32):
    """The template as ``meta`` tensors: every leaf's shape and dtype, no
    storage (the dry-run builds full-size models this way)."""
    return _map(template, lambda d: torch.empty(d.shape, dtype=dtype,
                                                device="meta"))


def param_axes(template):
    """The tree of logical-axes tuples, in the parameters' structure."""
    return _map(template, lambda d: d.axes)


def scan_vjp(chunked: Callable, ctx, cotangents) -> Tuple:
    """The backward of a scan's autograd Function: recompute
    ``chunked(*ctx.saved_tensors)`` (the scan's plain chunked form,
    returning (y, final state)) under autograd and return its gradients
    against the ``cotangents`` that are not None, for the inputs that need
    one (None for the others)."""
    needs = ctx.needs_input_grad
    xs = [x.detach().requires_grad_(need)
          for x, need in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
        outs = chunked(*xs)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        wanted = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
    return tuple(next(grads) if need else None for need in needs)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in float32 with a (1 + weight) gain, back in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def rope(positions: torch.Tensor, d_head: int, theta: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> (sin, cos) each [..., S, d_head/2], fp32."""
    half = d_head // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions.float()[..., None] * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, H, d_head]; sin/cos [..., S, half] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu_sq": lambda x: torch.square(F.relu(x)),
}


def mlp_params(d_model: int, d_ff: int, act: str) -> Dict:
    """Gated (SwiGLU/GeGLU) or plain MLP template."""
    p = {"wi": dense_init((d_model, "embed"), (d_ff, "mlp")),
         "wo": dense_init((d_ff, "mlp"), (d_model, "embed"))}
    if act in ("silu", "gelu"):
        p["wg"] = dense_init((d_model, "embed"), (d_ff, "mlp"))
    return p


def mlp_apply(p: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    a = _ACTS[act]
    h = x @ p["wi"]
    if "wg" in p:
        h = a(x @ p["wg"]) * h
    else:
        h = a(h)
    return h @ p["wo"]
