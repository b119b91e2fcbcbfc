"""Serving engine: continuous batching over a fixed-slot decode batch (the
JAX package's ``serve/engine.py``).

- a **fixed decode batch** of ``n_slots`` sequences: every engine step
  decodes all slots, live or not, so the decode shapes never change;
- **continuous batching**: when a sequence finishes, its slot is refilled
  from the admission queue at the next step boundary (the new request's
  prefill runs alone, then its cache is copied into the slot);
- **prefix cache**: a prompt seen before reuses its prefill logits and KV
  cache instead of running the prefill again.

The engine runs on the model's device.  ``prefills`` counts prefills that
ran (prefix-cache misses) and ``decode_steps`` the decode steps taken, so a
run can account for every attention-kernel launch.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .sampling import sample_token

__all__ = ["Request", "ServeConfig", "InferenceEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    # vocab-restricted decoding (projection pushdown analogue)
    allowed_tokens: Optional[Tuple[int, ...]] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 4
    max_len: int = 512
    eos_token: int = 1
    prefix_cache: bool = True


class InferenceEngine:
    def __init__(self, model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * cfg.n_slots
        self.cache: Optional[Dict[str, Any]] = None    # batched decode cache
        self._prefix_cache: Dict[bytes, Tuple[torch.Tensor, Dict]] = {}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self.completed: List[Request] = []
        self.prefills = 0
        self.decode_steps = 0

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        req.submitted_at = time.time()
        self.queue.append(req)

    # -- cache plumbing --------------------------------------------------------
    def _blank_cache(self) -> Dict[str, Any]:
        specs = self.model.cache_specs(self.cfg.n_slots, self.cfg.max_len)

        def zero(spec):
            shape, dtype = spec
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return {"len": zero(specs["len"]),
                "layers": [{k: zero(s) for k, s in layer.items()}
                           for layer in specs["layers"]]}

    def _splice_slot(self, slot_cache: Dict[str, Any], slot: int) -> None:
        """Copy one sequence's prefill cache into batch slot ``slot``."""
        for dst, src in zip(self.cache["layers"], slot_cache["layers"]):
            for name, buf in dst.items():
                buf[slot].copy_(src[name][0])
        self.cache["len"][slot] = slot_cache["len"][0]

    # -- main step ---------------------------------------------------------------
    def _admit(self, params) -> None:
        for slot in range(self.cfg.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            key = req.prompt.tobytes()
            if self.cfg.prefix_cache and key in self._prefix_cache:
                logits, pcache = self._prefix_cache[key]
            else:
                tokens = torch.as_tensor(req.prompt, device=self.device)
                logits, pcache = self.model.prefill(
                    params, tokens[None], max_len=self.cfg.max_len)
                self.prefills += 1
                if self.cfg.prefix_cache:
                    self._prefix_cache[key] = (logits, pcache)
            if self.cache is None:
                self.cache = self._blank_cache()
            self._splice_slot(pcache, slot)
            tok = sample_token(logits, req.temperature, self._generator,
                               allowed=req.allowed_tokens)[0]
            req.output.append(int(tok))
            req.first_token_at = time.time()
            self.slots[slot] = req
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> bool:
        req = self.slots[slot]
        if req is None:
            return False
        tok = req.output[-1]
        done = (tok == self.cfg.eos_token
                or len(req.output) >= req.max_new_tokens
                or int(self.cache["len"][slot]) >= self.cfg.max_len - 1)
        if done:
            req.finished_at = time.time()
            self.completed.append(req)
            self.slots[slot] = None
        return done

    def step(self, params) -> int:
        """One engine iteration: admit, decode one token for every slot,
        retire finished sequences.  Returns #live slots."""
        self._admit(params)
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return 0
        last = torch.zeros((self.cfg.n_slots, 1), dtype=torch.int32)
        for i in live:
            last[i, 0] = self.slots[i].output[-1]
        logits, self.cache = self.model.decode_step(
            params, self.cache, last.to(self.device))
        self.decode_steps += 1
        for i in live:
            req = self.slots[i]
            tok = int(sample_token(logits[i][None], req.temperature,
                                   self._generator,
                                   allowed=req.allowed_tokens)[0])
            req.output.append(tok)
            self._maybe_finish(i)
        return len([r for r in self.slots if r is not None])

    def run_until_drained(self, params, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.queue or any(r is not None for r in self.slots)) \
                and steps < max_steps:
            self.step(params)
            steps += 1
