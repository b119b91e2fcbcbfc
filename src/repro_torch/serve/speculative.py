"""Speculative decoding: draft-propose, target-verify, greedy-exact (the
JAX package's ``serve/speculative.py``).

A small draft model proposes ``k`` tokens autoregressively; the target model
scores the whole proposal in ONE forward pass and accepts the longest prefix
that matches its own greedy choices (plus one free token from the position
after the last accepted draft token).  The output is target greedy decoding
through the same full-forward path (``greedy_decode``).

The verify pass recomputes the full prefix for structural clarity, as the
JAX package's does.  Acceptance-rate statistics are returned so serving
tiers can tune k.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["SpecStats", "speculative_decode", "greedy_decode"]


@dataclasses.dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0
    draft_calls: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


def _tokens(model, tokens: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens, np.int32)[None],
                           device=model.device)


def _full_forward_logits(model, params, tokens: np.ndarray) -> torch.Tensor:
    """Logits at every position via one full forward (the verify path)."""
    h, _ = model._embed_inputs(params, _tokens(model, tokens))
    h, _ = model._decoder_stack(params, h)
    return model._logits(params, h)[0]


def greedy_decode(model, params, prompt: np.ndarray, n_tokens: int
                  ) -> List[int]:
    """Reference: greedy decoding through the same full-forward path the
    verifier uses (exactness is defined w.r.t. this path; the incremental
    bf16-KV decode path can differ by one ulp at argmax ties)."""
    seq = np.asarray(prompt, np.int32)
    out: List[int] = []
    for _ in range(n_tokens):
        logits = _full_forward_logits(model, params, seq)
        tok = int(torch.argmax(logits[-1]))
        out.append(tok)
        seq = np.concatenate([seq, np.asarray([tok], np.int32)])
    return out


def speculative_decode(target_model, target_params, draft_model,
                       draft_params, prompt: np.ndarray, n_tokens: int,
                       k: int = 4) -> Tuple[List[int], SpecStats]:
    """Greedy speculative decoding.  Returns (tokens, stats)."""
    stats = SpecStats()
    seq = np.asarray(prompt, np.int32)
    out: List[int] = []
    while len(out) < n_tokens:
        # --- draft proposes k tokens ---------------------------------------
        d_logits, d_cache = draft_model.prefill(
            draft_params, _tokens(draft_model, seq),
            max_len=seq.shape[0] + k + 2)
        stats.draft_calls += 1
        proposal: List[int] = [int(torch.argmax(d_logits[0]))]
        for _ in range(k - 1):
            d_logits, d_cache = draft_model.decode_step(
                draft_params, d_cache,
                torch.tensor([[proposal[-1]]], dtype=torch.int32,
                             device=draft_model.device))
            stats.draft_calls += 1
            proposal.append(int(torch.argmax(d_logits[0])))
        stats.proposed += len(proposal)

        # --- target verifies the whole proposal in one forward --------------
        ext = np.concatenate([seq, np.asarray(proposal, np.int32)])
        logits = _full_forward_logits(target_model, target_params, ext)
        stats.target_calls += 1
        # target's greedy choice *at* position len(seq)-1+i predicts token i
        base = seq.shape[0] - 1
        want = torch.argmax(logits[base:base + len(proposal) + 1],
                            dim=-1).tolist()
        n_accept = 0
        for i, tok in enumerate(proposal):
            if want[i] == tok:
                n_accept += 1
            else:
                break
        stats.accepted += n_accept
        accepted = proposal[:n_accept]
        # one free token: target's own prediction at the divergence point
        new = accepted + [want[n_accept]]
        out.extend(new)
        seq = np.concatenate([seq, np.asarray(new, np.int32)])
    return out[:n_tokens], stats
