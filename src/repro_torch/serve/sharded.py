"""Partition-parallel execution of fused prediction plans.

``core/partition.py`` gives tables row-range partitions with zone maps and
the ``partition_pruning`` rule marks each scan with its surviving
partitions; this module actually *runs* the fused plan data-parallel over
those partitions on a list of devices — every local device of the
catalog's type by default (``torch.cuda.device_count()`` cards, or the one
CPU), or an explicit list of ``torch.device``s.

Two pieces:

- :func:`plan_morsels` — the **partition-morsel scheduler**.  Surviving
  partitions pack (in partition order, so reassembly preserves row order)
  into *morsels* of at most one shared power-of-two row bucket, and
  morsels are assigned to devices longest-processing-time-first.  When the
  partition count exceeds the device count a device simply owns several
  morsels and executes them as sequential waves.  Every morsel pads to
  the *same* bucket, so however many partitions/devices/waves are in
  play, exactly one input signature reaches the executable per (plan
  signature, bucket, device count) — the discipline the serving layer's
  shape-bucketed executables already keep for batching.

- :class:`ShardedExecutor` — single-program multiple-data execution:
  **one** closure (the same program), run per device on that device's
  morsels from one worker thread per device (inline when one device is
  active).  Model constants are staged on each device the first time the
  closure meets it (``codegen.compile_plan``).

Rows stay on the devices.  A morsel's inputs are the catalog table's
partition row ranges, sliced and concatenated (``torch.cat``) on the
table's device, zero-padded to the bucket, and moved to the executing
device when that is another one; outputs are sliced back per partition
and reassembled with ``torch.cat`` in partition order.  Pad rows carry
``valid=False`` and row-local plans never mix rows, so the reassembled
output is bit-exact against single-device execution over the same
partitions.  Every morsel's result is synchronized on its device before
its wave ends, so a ``shard_wave`` span times the work, not its launch.

Beyond row-local scans (``core/rules/distributed_plan.py``):

- **aligned morsel pairs** — for a partition-wise join, every non-anchor
  join input is gathered from *its own* partitioned table at the morsel's
  partition indices (co-partitioning makes index ``i`` of both sides hold
  the same key range) and padded to that side's shared bucket
  (:func:`side_bucket_rows`), so the fused local join still sees exactly
  one input signature per (signature, buckets, devices);
- **combine stage** — for a two-phase aggregation the per-morsel outputs
  are mergeable partial states, not row slices: ``execute(...,
  combine=...)`` skips the per-partition split and folds the partials in
  ascending partition order (deterministic however morsels were placed,
  so 1-device and n-device runs of the same placement are bit-identical);
- **exchange stage** — for an equi-join whose sides are *not*
  co-partitioned, :meth:`ShardedExecutor.execute_exchange` runs the
  hash-repartition shuffle planned by ``serve/exchange.py``: both sides
  bucket by join-key hash, bucket ``b`` joins locally on device
  ``b % n_devices``, and the row-local outputs scatter back to the
  anchor's original row positions (bit-exact against whole-table by the
  contract documented in ``serve/exchange.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.codegen import _sync, pow2_bucket
from ..core.partition import Partition
from ..relational.table import Table, resolve_device

__all__ = ["Morsel", "ShardPlacement", "ShardedExecutor", "plan_morsels",
           "side_bucket_rows"]


@dataclasses.dataclass(frozen=True)
class Morsel:
    """A unit of device work: one or more whole partitions (ascending
    index; partitions are atomic — never split across morsels)."""

    partitions: Tuple[int, ...]
    rows: int


@dataclasses.dataclass(frozen=True)
class ShardPlacement:
    """Output of the morsel scheduler: who runs what at which shape."""

    bucket_rows: int                        # shared padded morsel shape
    assignments: Tuple[Tuple[Morsel, ...], ...]   # per device, in wave order
    total_rows: int

    @property
    def n_morsels(self) -> int:
        return sum(len(a) for a in self.assignments)

    @property
    def n_waves(self) -> int:
        return max((len(a) for a in self.assignments), default=0)

    @property
    def padded_rows(self) -> int:
        return self.n_morsels * self.bucket_rows


def plan_morsels(part_rows: Sequence[Tuple[int, int]], n_devices: int,
                 min_bucket_rows: int = 64,
                 morsel_rows: int = 1 << 16) -> ShardPlacement:
    """Pack surviving partitions into bucket-shaped morsels and balance
    them across ``n_devices``.

    ``part_rows`` is ``(partition index, row count)`` in ascending index
    order.  The bucket is the power-of-two cover of the ideal per-device
    share, clamped below by the largest single partition (partitions are
    atomic) and above by ``morsel_rows`` (the morsel granularity cap that
    turns a huge table on few devices into multiple waves instead of one
    giant executable)."""
    n_devices = max(1, int(n_devices))
    if not part_rows:
        return ShardPlacement(
            bucket_rows=max(1, int(min_bucket_rows)),
            assignments=tuple(() for _ in range(n_devices)), total_rows=0)
    total = sum(r for _, r in part_rows)
    largest = max(r for _, r in part_rows)
    target = -(-total // n_devices)                       # ceil
    cap = max(int(morsel_rows), largest)
    bucket = pow2_bucket(min(max(target, largest), cap),
                         min_rows=min_bucket_rows)

    morsels: List[Morsel] = []
    cur: List[int] = []
    cur_rows = 0
    for idx, rows in part_rows:
        if cur and cur_rows + rows > bucket:
            morsels.append(Morsel(tuple(cur), cur_rows))
            cur, cur_rows = [], 0
        cur.append(idx)
        cur_rows += rows
    if cur:
        morsels.append(Morsel(tuple(cur), cur_rows))

    # LPT: biggest morsel to the least-loaded device (ties by device id).
    loads = [0] * n_devices
    per_device: List[List[Morsel]] = [[] for _ in range(n_devices)]
    for m in sorted(morsels, key=lambda m: -m.rows):
        d = min(range(n_devices), key=lambda i: (loads[i], i))
        per_device[d].append(m)
        loads[d] += m.rows
    return ShardPlacement(bucket_rows=bucket,
                          assignments=tuple(tuple(a) for a in per_device),
                          total_rows=total)


def side_bucket_rows(placement: ShardPlacement, side_partitions:
                     Sequence[Partition], min_bucket_rows: int = 64) -> int:
    """Shared padded row bucket for one non-anchor join input: the pow-2
    cover of the largest per-morsel row total that side contributes when
    gathered at the placement's aligned partition indices.  One bucket per
    side keeps the input signature count at one however morsel
    compositions vary across waves."""
    most = 1
    for assignment in placement.assignments:
        for m in assignment:
            most = max(most, sum(side_partitions[i].n_rows
                                 for i in m.partitions))
    return pow2_bucket(most, min_rows=min_bucket_rows)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` names the current card: give it its index, so devices
    compare equal to the ones tensors report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _local_devices(home: Any) -> List[torch.device]:
    """Every local device of ``home``'s type: the cards for a CUDA home,
    the one CPU otherwise."""
    home = torch.device(home)
    if home.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(home.type)]


def _on(device: torch.device):
    """Make ``device`` current for the calling thread's launches."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _move(v: Any, device: torch.device) -> Any:
    """A morsel's result (table or tensor) on ``device`` (no copy when it
    is there already)."""
    return v if v.device == device else v.to(device)


def _rows_view(v: Any, start: int, stop: int) -> Any:
    if isinstance(v, Table):
        return Table({k: c[start:stop] for k, c in v.columns.items()},
                     v.valid[start:stop], v.schema)
    return v[start:stop]


def _concat_outputs(pieces: List[Any]) -> Any:
    """Row-wise concatenation of tables or tensors, in list order."""
    if isinstance(pieces[0], Table):
        base = pieces[0]
        cols = {k: torch.cat([p.columns[k] for p in pieces])
                for k in base.columns}
        valid = torch.cat([p.valid for p in pieces])
        return Table(cols, valid, base.schema)
    return torch.cat(pieces)


def _zeros_table(table: Table, rows: int, device: torch.device) -> Table:
    """All-padding table: ``table``'s columns and schema, ``rows`` zero
    rows, none valid."""
    return Table({k: torch.zeros((rows,) + tuple(v.shape[1:]),
                                 dtype=v.dtype, device=device)
                  for k, v in table.columns.items()},
                 torch.zeros((rows,), dtype=torch.bool, device=device),
                 table.schema)


class ShardedExecutor:
    """Runs a fused row-local plan over the surviving partitions of one
    scanned table, data-parallel across a list of devices.

    ``devices=0`` (or ``None``) takes every local device of ``home``'s
    type, a positive count the first that many (clamped to what exists),
    and a sequence of devices exactly those.  ``home`` is the device the
    catalog's tables live on (the card by default; ``"cpu"`` for a CPU
    catalog); without it an explicit list's first device is home."""

    def __init__(self, devices: Any = 0, home: Any = None):
        if isinstance(devices, (list, tuple)):
            if not devices:
                raise ValueError("sharded execution needs at least one "
                                 "device")
            self.devices: List[torch.device] = [_indexed(d)
                                                for d in devices]
            self.home = _indexed(resolve_device(home)) if home is not None \
                else self.devices[0]
        else:
            self.home = _indexed(resolve_device(home))
            local = [_indexed(d) for d in _local_devices(self.home)]
            n = len(local) if devices in (0, None) \
                else max(1, min(int(devices), len(local)))
            self.devices = local[:n]
        self.mesh_shape: Tuple[int, ...] = (len(self.devices),)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def plan(self, partitions: Sequence[Partition],
             min_bucket_rows: int = 64,
             morsel_rows: int = 1 << 16) -> ShardPlacement:
        return plan_morsels([(p.index, p.n_rows) for p in partitions],
                            self.n_devices, min_bucket_rows=min_bucket_rows,
                            morsel_rows=morsel_rows)

    def _dispatch(self, work: Dict[int, Callable[[], List[Any]]],
                  name: str) -> List[Any]:
        """Run each device's work list — inline when one device is active,
        else one worker thread per device, all joined before returning —
        and hand back every piece produced."""
        results: Dict[int, List[Any]] = {}
        errors: List[BaseException] = []

        def worker(d: int):
            try:
                with _on(self.devices[d]):
                    results[d] = work[d]()
            except BaseException as err:   # propagate to the caller
                errors.append(err)

        active = sorted(work)
        if len(active) == 1:
            with _on(self.devices[active[0]]):
                results[active[0]] = work[active[0]]()
        else:
            threads = [threading.Thread(target=worker, args=(d,),
                                        name=f"{name}-{d}")
                       for d in active]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        return [piece for d in active for piece in results[d]]

    def _run(self, fn, tables, device, unwrap, capture):
        """One morsel's (or bucket's) program, synchronized on its device:
        ``(output, captured-or-None)``."""
        raw = fn(tables)
        cap = None
        if capture:
            raw, cap = raw
        elif unwrap is not None:
            raw = unwrap(raw)
        _sync(device)
        return raw, cap

    def _empty(self, fn, tables, unwrap, combine, capture):
        """Every partition pruned (or no anchor row in any bucket): run one
        all-padding morsel to learn the output schema, then keep zero of
        its rows — or, for a combine stage, to produce the identity
        partial (no valid rows), which folds to the same aggregate the
        whole plan yields over a fully-filtered table."""
        raw, cap = self._run(fn, tables, self.home, unwrap, capture)
        if combine is not None:
            return combine([raw])
        if capture:
            return _rows_view(raw, 0, 0), _rows_view(cap, 0, 0)
        return _rows_view(raw, 0, 0)

    def execute(self, fn: Callable[[Dict[str, Table]], Any], source: Any,
                scan_name: str, partitions: Sequence[Partition],
                placement: ShardPlacement,
                unwrap: Optional[Callable[[Any], Any]] = None,
                sides: Optional[Dict[str, Tuple[Any, int]]] = None,
                combine: Optional[Callable[[List[Any]], Any]] = None,
                capture: bool = False, trace: Any = None) -> Any:
        """Execute ``fn`` over ``partitions`` of ``source`` per
        ``placement`` and reassemble the output in partition order.

        ``source`` is the base ``Table`` or its ``PartitionedTable``; the
        morsels are gathered from its columns on their device.  ``fn``
        is the fused plan taking ``{scan_name: Table, ...}``; ``unwrap``
        post-processes each morsel's raw result.  ``capture=True`` instead
        treats each raw result as an ``(output, capture)`` pair — both
        row-local over the anchor — and reassembles *both* in partition
        order, returning the pair (so the serving layer's result cache
        keeps its capture when execution went sharded).

        ``sides`` maps additional scan names (partition-wise join inputs)
        to ``(PartitionedTable, bucket_rows)``: each morsel gathers the
        *same partition indices* from every side — co-partitioning
        guarantees the aligned pair holds all possible matches — padded to
        that side's shared bucket.

        ``combine=None`` (row-local output): returns a ``Table`` or tensor
        whose rows are exactly the anchor's surviving partitions' rows, in
        their original order — bit-exact against a single-device run of
        the same plan over the same partitions.  With ``combine`` (two-
        phase aggregation) every morsel's output is a mergeable partial
        state; they are folded in ascending partition order
        (placement-independent, so any device count is bit-identical) and
        the combined value is returned.

        ``trace`` (a :class:`~repro_torch.serve.telemetry.Trace`, or
        ``None``) records one ``shard_wave`` span per morsel on track
        ``device+1`` — worker threads genuinely overlap, so spans go
        through the out-of-band ``add_span`` seam rather than the phase
        stack."""
        if capture and (combine is not None or unwrap is not None):
            raise ValueError("capture=True is row-local reassembly; it "
                             "composes with neither combine nor unwrap")
        part_map = {p.index: p for p in partitions}
        table = source.table if hasattr(source, "partitions") else source
        bucket = placement.bucket_rows
        # (table, partitions, bucket) per join side
        side_views = {name: (src.table, src.partitions, int(srows))
                      for name, (src, srows) in (sides or {}).items()}

        def gather_pad(t: Table, parts: Sequence[Partition], rows: int,
                       device: torch.device) -> Table:
            pad = rows - sum(p.n_rows for p in parts)

            def gather(v: torch.Tensor) -> torch.Tensor:
                pieces = [v[p.start:p.stop] for p in parts]
                if pad > 0:
                    pieces.append(v.new_zeros((pad,) + tuple(v.shape[1:])))
                return (pieces[0] if len(pieces) == 1
                        else torch.cat(pieces)).to(device)

            return Table({k: gather(v) for k, v in t.columns.items()},
                         gather(t.valid), t.schema)

        def prepare_morsel(device: torch.device,
                           morsel: Morsel) -> Dict[str, Table]:
            """Gather + pad one morsel's inputs (anchor plus any aligned
            join sides) on the tables' device, then move them to the
            executing device."""
            parts = [part_map[i] for i in morsel.partitions]
            tables = {scan_name: gather_pad(table, parts, bucket, device)}
            for name, (s_table, s_parts, srows) in side_views.items():
                aligned = [s_parts[i] for i in morsel.partitions]
                tables[name] = gather_pad(s_table, aligned, srows, device)
            return tables

        active = [d for d in range(self.n_devices)
                  if placement.assignments[d]]
        if not active:
            tables = {scan_name: _zeros_table(table, bucket, self.home)}
            for name, (s_table, _p, srows) in side_views.items():
                tables[name] = _zeros_table(s_table, srows, self.home)
            return self._empty(fn, tables, unwrap, combine, capture)

        prepared = {d: [(m, prepare_morsel(self.devices[d], m))
                        for m in placement.assignments[d]]
                    for d in active}
        live = trace is not None and getattr(trace, "enabled", False)

        def run_device(d: int) -> List[Tuple[int, Any, Any]]:
            device = self.devices[d]
            pieces: List[Tuple[int, Any, Any]] = []
            for morsel, tables in prepared[d]:
                t0 = trace.clock.monotonic() if live else 0.0
                parts = [part_map[i] for i in morsel.partitions]
                raw, cap = self._run(fn, tables, device, unwrap, capture)
                if live:
                    trace.add_span("shard_wave", t0,
                                   trace.clock.monotonic(), tid=d + 1,
                                   device=d,
                                   partitions=len(morsel.partitions),
                                   rows=morsel.rows)
                if combine is not None:
                    # partial-aggregate state: one mergeable value per
                    # morsel, ordered by its first partition for the fold
                    pieces.append((parts[0].index, raw, None))
                    continue
                # split back per partition; trailing pad rows fall off
                off = 0
                for p in parts:
                    pieces.append((
                        p.index, _rows_view(raw, off, off + p.n_rows),
                        _rows_view(cap, off, off + p.n_rows)
                        if capture else None))
                    off += p.n_rows
            return pieces

        pieces = sorted(self._dispatch(
            {d: (lambda d=d: run_device(d)) for d in active},
            "shard-exec"), key=lambda trip: trip[0])
        if combine is not None:
            return combine([p[1] for p in pieces])
        out = _concat_outputs([_move(p[1], self.home) for p in pieces])
        if capture:
            return out, _concat_outputs([_move(p[2], self.home)
                                         for p in pieces])
        return out

    def execute_exchange(self, fn: Callable[[Dict[str, Table]], Any],
                         anchor: Table, scan_name: str, side: Table,
                         side_name: str, placement,
                         unwrap: Optional[Callable[[Any], Any]] = None,
                         combine: Optional[Callable[[List[Any]], Any]] = None,
                         capture: bool = False, trace: Any = None) -> Any:
        """Execute ``fn`` via a hash-repartition shuffle exchange.

        ``anchor`` and ``side`` are tables already restricted to the
        surviving rows (in original order — the rows the placement's index
        arrays address); ``placement`` is the :class:`~repro_torch.serve.
        exchange.ExchangePlacement` planned from their join-key columns.
        Bucket ``b`` gathers both sides' bucket-``b`` rows with index
        tensors on the tables' device, pads each to its side's shared
        pow-2 capacity, moves them to device ``b % n_devices``, and runs
        the same ``fn`` — one input signature for every bucket, so warm
        repeats compile nothing.

        Row-local output (``combine=None``): bucket outputs scatter back
        to the anchor rows' original positions, so the result is bitwise
        the whole-table output (valid rows and validity mask alike) for
        any bucket count or device count.  With ``combine`` each bucket
        yields a mergeable partial state, folded in ascending bucket
        order — deterministic however buckets were placed."""
        if capture and (combine is not None or unwrap is not None):
            raise ValueError("capture=True is row-local reassembly; it "
                             "composes with neither combine nor unwrap")
        from .exchange import take_pad

        def bucket_table(t: Table, idx: np.ndarray, cap: int,
                         device: torch.device) -> Table:
            index = torch.as_tensor(idx, dtype=torch.int64,
                                    device=t.device)
            return Table({k: take_pad(v, index, cap).to(device)
                          for k, v in t.columns.items()},
                         take_pad(t.valid, index, cap).to(device), t.schema)

        active = list(placement.active_buckets)
        if not active:
            tables = {scan_name: _zeros_table(anchor, placement.anchor_rows,
                                              self.home),
                      side_name: _zeros_table(side, placement.side_rows,
                                              self.home)}
            return self._empty(fn, tables, unwrap, combine, capture)

        # bucket b -> device b % n_devices; several buckets on one device
        # execute as sequential waves, mirroring the morsel scheduler
        per_device: Dict[int, List[int]] = {}
        for b in active:
            per_device.setdefault(b % self.n_devices, []).append(b)
        prepared = {
            d: [(b, {scan_name: bucket_table(
                        anchor, placement.anchor_index[b],
                        placement.anchor_rows, self.devices[d]),
                     side_name: bucket_table(
                        side, placement.side_index[b],
                        placement.side_rows, self.devices[d])})
                for b in buckets]
            for d, buckets in per_device.items()}
        live = trace is not None and getattr(trace, "enabled", False)

        def run_device(d: int) -> List[Tuple[int, Any, Any]]:
            device = self.devices[d]
            pieces: List[Tuple[int, Any, Any]] = []
            for b, tables in prepared[d]:
                t0 = trace.clock.monotonic() if live else 0.0
                raw, cap = self._run(fn, tables, device, unwrap, capture)
                rows = len(placement.anchor_index[b])
                if live:
                    trace.add_span(
                        "exchange_bucket", t0, trace.clock.monotonic(),
                        tid=d + 1, device=d, bucket=b, rows=rows)
                if combine is not None:
                    pieces.append((b, raw, None))
                    continue
                pieces.append((b, _rows_view(raw, 0, rows),
                               _rows_view(cap, 0, rows) if capture
                               else None))
            return pieces

        pieces = sorted(self._dispatch(
            {d: (lambda d=d: run_device(d)) for d in per_device},
            "exchange-exec"), key=lambda trip: trip[0])
        if combine is not None:
            return combine([p[1] for p in pieces])

        # scatter bucket outputs back to original anchor row positions:
        # `order` is where each stacked row came from, `inv` sends it home
        t_scatter = trace.clock.monotonic() if live else 0.0
        order = np.concatenate(
            [placement.anchor_index[b] for b, _, _ in pieces])
        inv_host = np.empty(placement.total_rows, np.int64)
        inv_host[order] = np.arange(len(order))
        inv = torch.as_tensor(inv_host, device=self.home)

        def reassemble(items: List[Any]) -> Any:
            stacked = _concat_outputs([_move(it, self.home) for it in items])
            if isinstance(stacked, Table):
                return Table({k: v.index_select(0, inv)
                              for k, v in stacked.columns.items()},
                             stacked.valid.index_select(0, inv),
                             stacked.schema)
            return stacked.index_select(0, inv)

        out = reassemble([p[1] for p in pieces])
        cap_out = reassemble([p[2] for p in pieces]) if capture else None
        if live:
            _sync(self.home)
            trace.add_span("exchange_scatter", t_scatter,
                           trace.clock.monotonic(),
                           buckets=len(pieces), rows=len(order))
        if capture:
            return out, cap_out
        return out
