"""Hash-repartition shuffle exchange: shard *any* equi-join.

``serve/sharded.py`` runs partition-wise joins only when both sides are
co-partitioned by construction — a lucky-layout executor.  This module is
the exchange stage that removes the luck: both sides of a non-co-
partitioned equi-join are hash-bucketed **on the join key** into
``n_buckets`` key ranges, each bucket is gathered and padded on the
tables' device and moved to its executing device, and the per-bucket local
joins are scattered back to the anchor's original row order.

The *plan* of the shuffle is made on the host in numpy: the join-key
columns come across once a serve (4 bytes a row for an int32 key), are
hashed with the splitmix64 mix below — ``uint64`` arithmetic with
wrap-around multiplies and an unsigned modulo, which numpy does natively —
and split into per-bucket row-index arrays.  The rows themselves never
leave the device: ``take_pad`` gathers a column with an index tensor.

Correctness argument (the determinism contract the property tests pin):

- every key value hashes to exactly one bucket, on both sides — so each
  anchor row's (unique-key) match is inside its own bucket, for *any*
  bucket count;
- within a bucket, rows keep **ascending original row order**
  (``np.nonzero`` of the bucket mask), and ``join_unique`` resolves
  duplicate right keys by a *stable* sort — the bucket-local subset
  preserves relative order, so each anchor row finds the *same* match it
  would whole-table;
- outputs are row-local over the anchor, so scattering bucket outputs
  back to the anchor rows' original positions reproduces the whole-table
  output bit-for-bit on valid rows (and the validity mask itself), however
  buckets were sized or placed — placement-independent by construction.

Invalid (NULL-key) rows are routed by the hash of whatever value the key
slot holds: deterministic, and irrelevant to the output — their rows stay
masked either way, but anchor-side invalid rows must still ride along so
their positions (and ``valid=False`` slots) scatter back.

Skew is safe, not fast: all keys hashing to one bucket simply makes that
bucket's pow-2 capacity cover everything (the other buckets run empty and
are skipped); the result is still bit-exact.

Float keys are normalized (``x + 0.0`` folds ``-0.0`` into ``+0.0`` so
equal-comparing keys share a bucket) and hashed on their float64 bit
pattern; NaN keys never match anything, so their routing is arbitrary but
deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..core.codegen import pow2_bucket
from ..relational.table import to_numpy

__all__ = ["ExchangePlacement", "choose_bucket_count", "hash_buckets",
           "plan_exchange", "take_pad"]


def hash_buckets(keys: Any, n_buckets: int) -> np.ndarray:
    """Deterministic bucket id per row: splitmix64-style mix of the key's
    64-bit pattern, mod ``n_buckets``.  Pure value hashing — no RNG, no
    placement input — so the same registered data always produces the
    same split (which is what keeps warm serves at zero compiles: bucket
    capacities are data-deterministic).  ``keys`` may be a tensor on any
    device; it is hashed on the host."""
    k = to_numpy(keys)
    if k.dtype.kind == "f":
        # +0.0 folds -0.0 in; float64 widening is exact for f32/f16
        k = (k.astype(np.float64) + 0.0).view(np.int64)
    elif k.dtype.kind == "b":
        k = k.astype(np.int64)
    h = k.astype(np.uint64)
    with np.errstate(over="ignore"):
        h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = h ^ (h >> np.uint64(31))
    return (h % np.uint64(max(int(n_buckets), 1))).astype(np.int64)


def choose_bucket_count(total_rows: int, n_devices: int,
                        morsel_rows: int = 1 << 16) -> int:
    """Deterministic bucket count: one bucket per device, doubled while
    the average bucket would exceed the morsel granularity cap — a huge
    table on few devices shuffles into multiple waves of morsel-sized
    buckets instead of a few giant ones (mirroring ``plan_morsels``)."""
    n = max(int(n_devices), 1)
    cap = max(int(morsel_rows), 1)
    while total_rows > n * cap:
        n *= 2
    return n


@dataclasses.dataclass(frozen=True)
class ExchangePlacement:
    """Output of the shuffle planner: who goes where at which shape.

    ``anchor_index[b]`` / ``side_index[b]`` are the original row positions
    (ascending) each side contributes to bucket ``b``; ``anchor_rows`` /
    ``side_rows`` are the shared pow-2 per-bucket capacities (covers of
    the largest bucket — one executable shape however skewed the split).
    Bucket ``b`` runs on device ``b % n_devices``; buckets beyond the
    device count execute as sequential waves."""

    n_buckets: int
    anchor_rows: int
    side_rows: int
    anchor_index: Tuple[np.ndarray, ...]
    side_index: Tuple[np.ndarray, ...]
    total_rows: int

    @property
    def active_buckets(self) -> Tuple[int, ...]:
        """Buckets holding at least one anchor row.  Output rows follow
        the anchor, so a bucket without anchor rows contributes nothing
        (any side rows it holds have no in-bucket match by the hashing
        argument) and is skipped."""
        return tuple(b for b in range(self.n_buckets)
                     if len(self.anchor_index[b]))

    def n_waves(self, n_devices: int) -> int:
        per_device: Dict[int, int] = {}
        for b in self.active_buckets:
            d = b % max(int(n_devices), 1)
            per_device[d] = per_device.get(d, 0) + 1
        return max(per_device.values(), default=0)

    def bytes_moved(self, anchor_row_bytes: int, side_row_bytes: int) -> int:
        """Actual payload the shuffle gathers (pre-padding): observability
        for the exchange ledger, and the quantity the cost gate models."""
        a = sum(len(i) for i in self.anchor_index)
        s = sum(len(i) for i in self.side_index)
        return a * int(anchor_row_bytes) + s * int(side_row_bytes)

    def describe(self) -> Dict[str, Any]:
        """Shuffle-shape summary for trace attrs / EXPLAIN: bucket counts,
        row totals, and skew (largest bucket's share of a perfectly even
        split; 1.0 = balanced)."""
        sizes = [len(i) for i in self.anchor_index]
        total = sum(sizes)
        active = len(self.active_buckets)
        even = total / active if active else 0.0
        return {
            "n_buckets": self.n_buckets,
            "active_buckets": active,
            "anchor_rows_total": total,
            "side_rows_total": sum(len(i) for i in self.side_index),
            "bucket_capacity": self.anchor_rows,
            "skew": (max(sizes) / even) if even else 1.0,
        }


def plan_exchange(anchor_keys: Any, side_keys: Any, n_buckets: int,
                  min_bucket_rows: int = 64) -> ExchangePlacement:
    """Hash both sides' join-key columns and plan the bucket split.  The
    key arrays must already be restricted to the surviving (post-pruning)
    rows, in their original order — bucket membership and within-bucket
    order both derive from nothing but the key values and row positions,
    which is the whole determinism contract."""
    n_buckets = max(int(n_buckets), 1)
    ab = hash_buckets(anchor_keys, n_buckets)
    sb = hash_buckets(side_keys, n_buckets)
    anchor_index = tuple(np.nonzero(ab == b)[0] for b in range(n_buckets))
    side_index = tuple(np.nonzero(sb == b)[0] for b in range(n_buckets))
    a_cap = pow2_bucket(max((len(i) for i in anchor_index), default=1),
                        min_rows=min_bucket_rows)
    s_cap = pow2_bucket(max((len(i) for i in side_index), default=1),
                        min_rows=min_bucket_rows)
    return ExchangePlacement(
        n_buckets=n_buckets, anchor_rows=a_cap, side_rows=s_cap,
        anchor_index=anchor_index, side_index=side_index,
        total_rows=int(len(ab)))


def take_pad(arr: torch.Tensor, idx: Any, capacity: int) -> torch.Tensor:
    """Gather ``idx`` rows of ``arr`` on its own device (``idx`` an index
    tensor there, or an index array moved to it) and zero-pad to
    ``capacity`` rows — the per-bucket slice of one column or validity
    mask.  Pad rows are all-zero, so a padded validity mask carries
    ``valid=False`` and row-local plans never see the padding."""
    index = torch.as_tensor(idx, dtype=torch.int64, device=arr.device)
    taken = arr.index_select(0, index)
    pad = int(capacity) - taken.shape[0]
    if pad <= 0:
        return taken
    return torch.cat([taken, taken.new_zeros(
        (pad,) + tuple(taken.shape[1:]))])
