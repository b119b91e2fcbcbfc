"""AdamW, the learning-rate schedules (MiniCPM's WSD, cosine, constant) and
global-norm clipping (the JAX package's ``train/optimizer.py``).

The schedule, the clip scale and the bias corrections are float32 tensors
on the parameters' device, computed as JAX computes them: no host sync,
and no float64 Python arithmetic to give other bits.  ``adamw_update``
updates the parameters and the optimizer state in place, leaf by leaf,
under ``torch.no_grad()``: at MiniCPM-2B a second copy of the float32
parameters would be 10.9 GB.  The step's arithmetic per leaf is the JAX
package's, term for term.  Gradient compression (int8 with error
feedback) hooks in through ``distributed.compression``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from .tree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "wsd_schedule",
           "cosine_schedule", "schedule_fn", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"       # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_fraction: float = 0.1    # WSD: last fraction decays


def wsd_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, long
    stable plateau at peak, sharp (exponential-ish) decay in the final
    ``decay_fraction`` of training."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    decay_start = cfg.total_steps * (1.0 - cfg.decay_fraction)
    decay_len = max(cfg.total_steps - decay_start, 1.0)
    frac = torch.clamp((step - decay_start) / decay_len, 0.0, 1.0)
    decayed = cfg.peak_lr * 0.5 ** (frac * 10.0)   # ~3 decades over decay
    stable = torch.full_like(step, cfg.peak_lr)
    return torch.where(step < cfg.warmup_steps, warm,
                       torch.where(step < decay_start, stable, decayed))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.peak_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def schedule_fn(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (integer tensor) -> learning rate (float32 tensor, same
    device)."""
    if cfg.schedule == "wsd":
        return lambda s: wsd_schedule(cfg, s)
    if cfg.schedule == "constant":
        return lambda s: torch.full_like(s, cfg.peak_lr,
                                         dtype=torch.float32)
    return lambda s: cosine_schedule(cfg, s)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_init(params) -> Dict[str, Any]:
    """Zero first and second moments (float32, like each parameter) and a
    zero int32 step on the parameters' device."""
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    device = leaves(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
@torch.profiler.record_function("adamw_update")
def adamw_update(cfg: AdamWConfig, params, grads, opt_state
                 ) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step with global-norm clipping, written into ``params``
    and ``opt_state`` (``m``, ``v``, ``step``) in place; returns them.
    ``grads`` is read, not changed.  A profiler range of this name spans
    it."""
    step = opt_state["step"] + 1
    lr = schedule_fn(cfg)(step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p - lr * delta)
    opt_state["step"].copy_(step)
    return params, opt_state
