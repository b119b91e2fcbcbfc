"""Train state and train step, with gradient accumulation, a gradient
compression hook and the non-finite skip (the JAX package's
``train/train_state.py``).

The state is ``{"params": ..., "opt": {"m", "v", "step"}}``, float32
master parameters and moments on the model's device.  Unlike the JAX
package's pure step, ``train_step`` updates the state in place (see
``optimizer.adamw_update``) and returns it: copy a state before stepping
it if the old one is still needed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm
from .tree import leaves, tree_map, unflatten

__all__ = ["init_train_state", "abstract_train_state", "make_train_step",
           "loss_and_grads"]


def init_train_state(model, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameters from ``generator`` (``model.init_params``) and a
    fresh AdamW state."""
    params = model.init_params(generator)
    return {"params": params, "opt": adamw_init(params)}


def abstract_train_state(model) -> Dict[str, Any]:
    """The train state as ``meta`` tensors (no storage): the parameters of
    ``model.abstract_params()``, float32 moments like each of them and an
    int32 step."""
    params = model.abstract_params()

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"params": params,
            "opt": {"m": tree_map(f32, params), "v": tree_map(f32, params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def loss_and_grads(model, params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, d loss / d params) of ``model.train_loss`` by autograd, the
    gradients float32 in ``params``' structure (zeros for a parameter the
    loss does not reach, as ``jax.grad`` gives)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = model.train_loss(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float() for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def _on_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(model, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    compress_grads: Optional[Callable] = None,
                    skip_nonfinite: bool = True) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds numpy arrays or tensors, moved to the model's device.

    - ``grad_accum > 1`` splits the batch into that many microbatches along
      dim 0, sums their gradients (and losses) into float32 zeros in order
      and scales the sums by 1 / grad_accum.
    - ``compress_grads`` transforms the gradients before the update (int8
      with error feedback lives in ``distributed.compression``).
    - ``skip_nonfinite``: a non-finite loss or gradient norm skips the
      update, leaving parameters, moments and step count as they were.
      Deciding it reads one boolean from the device a step (and then skips
      the update's work outright).
    - metrics: ``loss``, ``grad_norm`` (before clipping) and ``skipped``
      (0 or 1), device tensors.
    """

    def compute_grads(params, batch):
        if grad_accum == 1:
            return loss_and_grads(model, params, batch)
        b = next(iter(batch.values())).shape[0]
        if b % grad_accum:
            raise ValueError(f"batch of {b} does not split into "
                             f"{grad_accum} microbatches")
        mb = b // grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves(params)]
        for i in range(grad_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, grads = loss_and_grads(model, params, micro)
            loss_sum = loss_sum + loss
            for acc, g in zip(grad_sum, leaves(grads)):
                acc.add_(g)
        scale = 1.0 / grad_accum
        return loss_sum * scale, unflatten(
            params, [g.mul_(scale) for g in grad_sum])

    def train_step(state, batch):
        batch = _on_device(batch, model.device)
        loss, grads = compute_grads(state["params"], batch)
        if compress_grads is not None:
            grads = compress_grads(grads)
        gnorm = global_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        skip = skip_nonfinite and not bool(finite)
        if not skip:
            adamw_update(opt_cfg, state["params"], grads, state["opt"])
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped": torch.tensor(int(skip), dtype=torch.int32)}
        return state, metrics

    return train_step
