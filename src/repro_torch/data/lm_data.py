"""Deterministic, seekable LM token pipeline with host prefetch (the JAX
package's ``data/lm_data.py``, plain numpy: the port keeps its own copy).

Restart-exactly-once needs the stream to be a pure function of (seed,
step): batch k is always the same tokens, on any host, after any restart.
``TokenStream`` synthesizes a Zipf-distributed stream with short-range
structure (enough for the loss to drop in a few steps) from numpy's
``default_rng`` keyed by (seed, step), bit for bit the JAX package's.

``PrefetchIterator`` overlaps host batch synthesis with device compute: a
host thread makes the next batches, and, where a device is given, copies
them there from pinned memory without blocking.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["TokenStream", "PrefetchIterator"]


class TokenStream:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.3,
                 extra_specs: Optional[Dict] = None):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a
        self.extra_specs = dict(extra_specs or {})
        # fixed Zipf-ish unigram table (stable across restarts)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): ``tokens`` int32 [B,S], and one
        standard-normal array per extra spec ``name: (shape, dtype)``."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        u = rng.random((self.global_batch, self.seq_len))
        tokens = np.searchsorted(self._cdf, u).astype(np.int32)
        # short-range structure: with prob .5 repeat the previous token + 1
        rep = rng.random((self.global_batch, self.seq_len)) < 0.5
        shifted = np.roll(tokens, 1, axis=1)
        tokens = np.where(rep, (shifted + 1) % self.vocab_size, tokens)
        tokens = np.clip(tokens, 0, self.vocab_size - 1)
        out = {"tokens": tokens}
        for name, (shape, dtype) in self.extra_specs.items():
            out[name] = rng.standard_normal(
                (self.global_batch,) + tuple(shape)).astype(dtype)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PrefetchIterator:
    """Host-thread prefetch of upcoming batches (at most ``depth`` ahead).

    ``next(it)`` -> (step, batch).  With ``device`` None the batch holds
    the stream's numpy arrays; otherwise torch tensors on ``device``,
    copied from pinned host memory with ``non_blocking`` copies (on the
    card the copy overlaps whatever runs on the current stream).  Call
    ``close()`` to stop the thread."""

    def __init__(self, stream: TokenStream, start_step: int = 0,
                 depth: int = 2, device: Any = None):
        self.stream = stream
        self.depth = depth
        self.device = None if device is None else torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        pin = self.device is not None and self.device.type == "cuda"
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self.stream.batch(step)
                if self.device is not None:
                    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
                    if pin:
                        batch = {k: v.pin_memory() for k, v in batch.items()}
            try:
                self._q.put((step, batch), timeout=1.0)
            except queue.Full:
                continue
            batch = None
            step += 1

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Tuple[int, Dict[str, Any]]:
        step, batch = self._q.get()
        if self.device is not None:
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in batch.items()}
        return step, batch

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
