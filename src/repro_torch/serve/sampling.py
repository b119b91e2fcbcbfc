"""Token sampling: greedy / temperature / top-k / vocab-restricted (the JAX
package's ``serve/sampling.py``, with a ``torch.Generator`` in place of the
JAX key).

Vocab restriction is the LM analogue of the paper's model-projection
pushdown: a query that only consumes a candidate set masks every other
logit before the softmax.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["sample_token", "restrict_vocab"]


def restrict_vocab(logits: torch.Tensor,
                   allowed: Sequence[int]) -> torch.Tensor:
    """Mask logits outside the allowed candidate set to -inf."""
    mask = torch.zeros(logits.shape[-1], dtype=torch.bool,
                       device=logits.device)
    mask[torch.as_tensor(list(allowed), dtype=torch.long,
                         device=logits.device)] = True
    return torch.where(mask, logits, float("-inf"))


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None,
                 top_k: int = 0,
                 allowed: Optional[Sequence[int]] = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.  Greedy (first maximum) when
    ``temperature <= 0``; otherwise a draw from softmax(logits / T) by the
    Gumbel-max rule, as ``jax.random.categorical`` draws, with uniforms from
    ``generator`` (which must live on the logits' device)."""
    if allowed is not None:
        logits = restrict_vocab(logits, allowed)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
