"""Paged KV cache: block-pool allocator + block-table gather (the JAX
package's ``serve/kv_cache.py``).

vLLM-style paging: a pool ``[n_blocks, block, kv, hd]`` per layer on the
device, per-sequence block tables on the host (``[max_blocks]`` int32, -1 =
unallocated), and a gather that assembles each sequence's contiguous view
for attention.  Memory scales with the tokens used (at most ``block - 1``
slots wasted a sequence), not with a per-slot ``max_len``, and freeing a
sequence returns whole blocks to the pool.

The gathered view goes to ``decode_attention`` unchanged: its cache-length
masking covers the ragged tail and the unallocated blocks (which read
block 0).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..relational.table import resolve_device

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Host-managed allocator, device-resident pool (one layer's K or V).

    Allocation and free are host decisions (the scheduler's, as in vLLM);
    ``append`` writes the pool in place and ``gather`` reads it on the
    device.  ``device=None`` means the card and raises without one.
    """

    def __init__(self, n_blocks: int, block: int, n_kv: int, hd: int,
                 max_blocks_per_seq: int, dtype: torch.dtype = torch.bfloat16,
                 device: Any = None):
        self.block = block
        self.n_blocks = n_blocks
        self.max_blocks_per_seq = max_blocks_per_seq
        self.device = resolve_device(device)
        self.pool = torch.zeros((n_blocks, block, n_kv, hd), dtype=dtype,
                                device=self.device)
        self._free: List[int] = list(range(n_blocks))[::-1]
        self.tables: Dict[int, np.ndarray] = {}     # seq id -> block ids
        self.lengths: Dict[int, int] = {}

    # -- host-side bookkeeping ------------------------------------------------
    def allocate(self, sid: int) -> None:
        if sid in self.tables:
            raise ValueError(f"sequence {sid} is already allocated")
        self.tables[sid] = np.full((self.max_blocks_per_seq,), -1, np.int32)
        self.lengths[sid] = 0

    def free(self, sid: int) -> None:
        for b in self.tables.pop(sid):
            if b >= 0:
                self._free.append(int(b))
        self.lengths.pop(sid)

    def free_blocks(self) -> int:
        return len(self._free)

    def used_tokens(self, sid: int) -> int:
        return self.lengths[sid]

    def _ensure_block(self, sid: int) -> Tuple[int, int]:
        """Returns (block id, offset) for the next token of ``sid``."""
        n = self.lengths[sid]
        bidx, off = divmod(n, self.block)
        table = self.tables[sid]
        if bidx >= len(table):
            raise MemoryError(f"sequence {sid} is full: "
                              f"{self.max_blocks_per_seq} blocks")
        if table[bidx] < 0:
            if not self._free:
                raise MemoryError("KV pool exhausted")
            table[bidx] = self._free.pop()
        return int(table[bidx]), off

    # -- device ops --------------------------------------------------------------
    def append(self, sid: int, kv_token: torch.Tensor) -> None:
        """kv_token [n_kv, hd]: write the next position of sequence sid."""
        blk, off = self._ensure_block(sid)
        self.pool[blk, off] = kv_token.to(self.device, self.pool.dtype)
        self.lengths[sid] += 1

    def gather(self, sid: int) -> Tuple[torch.Tensor, int]:
        """Contiguous [max_len, n_kv, hd] view + valid length (the
        block-table indirection; unallocated blocks read block 0 and are
        masked by length)."""
        table = torch.as_tensor(np.maximum(self.tables[sid], 0),
                                dtype=torch.long, device=self.device)
        view = self.pool[table]                    # [max_blocks, blk, kv, hd]
        out = view.reshape(self.max_blocks_per_seq * self.block,
                           *self.pool.shape[2:])
        return out, self.lengths[sid]

    def batch_gather(self, sids: List[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, max_len, kv, hd] + lengths [B] int32 for batched decode."""
        views = []
        lens = []
        for s in sids:
            v, n = self.gather(s)
            views.append(v)
            lens.append(n)
        return torch.stack(views), torch.tensor(lens, dtype=torch.int32,
                                                device=self.device)
