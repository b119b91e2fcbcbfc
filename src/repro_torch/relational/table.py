"""Columnar tables with validity-mask bag semantics, on torch tensors.

A selection never compacts rows; it narrows the validity mask instead, so
every operator keeps its shapes and the whole plan stays on the device.
Every relational operator in :mod:`repro_torch.relational.ops` consumes and
produces ``Table`` objects whose ``valid`` mask marks live rows.
Aggregations, joins and materialization are all mask-aware, which preserves
SQL bag semantics exactly.

Columns are tensors of equal leading dimension on one device.  Categorical
/string columns are dictionary-encoded at ingest time
(``Table.from_pydict``): the device column holds int32 codes and the
dictionary lives host-side in the schema.  Keys and codes are int32 and
values float32, as in the JAX package (which runs with x64 off); torch
defaults integer constructors to int64, so every dtype here is set by hand.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ColumnSchema", "Schema", "Table", "to_numpy", "resolve_device"]


_NUMERIC_KINDS = {"i", "u", "f", "b"}


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    There is no quiet CPU fallback: without a CUDA device the caller must
    ask for the CPU explicitly (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return dev


def to_numpy(x: Any) -> np.ndarray:
    """Host copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    """Schema entry for one column."""

    name: str
    dtype: Any
    # For dictionary-encoded (categorical/string) columns: code -> value.
    dictionary: Optional[Tuple[Any, ...]] = None

    @property
    def is_categorical(self) -> bool:
        return self.dictionary is not None

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if self.dictionary is None:
            return codes
        lut = np.asarray(self.dictionary, dtype=object)
        out = np.empty(codes.shape, dtype=object)
        valid = (codes >= 0) & (codes < len(lut))
        out[valid] = lut[codes[valid]]
        out[~valid] = None
        return out


@dataclasses.dataclass(frozen=True)
class Schema:
    columns: Tuple[ColumnSchema, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    def field(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"no column {name!r}; have {self.names}")

    def with_column(self, col: ColumnSchema) -> "Schema":
        cols = [c for c in self.columns if c.name != col.name]
        return Schema(tuple(cols) + (col,))

    def select(self, names: Sequence[str]) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def rename(self, mapping: Mapping[str, str]) -> "Schema":
        return Schema(
            tuple(
                dataclasses.replace(c, name=mapping.get(c.name, c.name))
                for c in self.columns
            )
        )


def _as_tensor(v: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v if device is None else v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


class Table:
    """A columnar table: dict of equal-length tensor columns + validity mask
    (bool), all on one device."""

    def __init__(self, columns: Dict[str, torch.Tensor], valid: torch.Tensor,
                 schema: Schema):
        self.columns = dict(columns)
        self.valid = valid
        self.schema = schema

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_pydict(cls, data: Mapping[str, Iterable[Any]],
                    dictionaries: Optional[Mapping[str, Sequence[Any]]] = None,
                    device: Any = "cpu") -> "Table":
        """Ingest host data; dictionary-encode non-numeric columns.  Host
        ingest lands on ``device`` (the CPU unless asked otherwise);
        ``ModelStore.register_table`` moves a table to the store's device."""
        device = torch.device(device)
        dictionaries = dict(dictionaries or {})
        cols: Dict[str, torch.Tensor] = {}
        fields: List[ColumnSchema] = []
        n = None
        for name, values in data.items():
            arr = np.asarray(values)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(f"column {name} length {arr.shape[0]} != {n}")
            if name in dictionaries or arr.dtype.kind not in _NUMERIC_KINDS:
                if name in dictionaries:
                    dictionary = list(dictionaries[name])
                else:
                    dictionary = sorted(set(arr.tolist()))
                index = {v: i for i, v in enumerate(dictionary)}
                codes = np.asarray([index[v] for v in arr.tolist()],
                                   dtype=np.int32)
                cols[name] = torch.from_numpy(codes).to(device)
                fields.append(ColumnSchema(name, torch.int32,
                                           tuple(dictionary)))
            else:
                if arr.dtype.kind == "f":
                    arr = arr.astype(np.float32)
                elif arr.dtype.kind in "iu":
                    arr = arr.astype(np.int32)
                elif arr.dtype.kind == "b":
                    arr = arr.astype(np.bool_)
                cols[name] = torch.from_numpy(
                    np.ascontiguousarray(arr)).to(device)
                fields.append(ColumnSchema(name, cols[name].dtype))
        if n is None:
            raise ValueError("empty table")
        valid = torch.ones((n,), dtype=torch.bool, device=device)
        return cls(cols, valid, Schema(tuple(fields)))

    @classmethod
    def from_arrays(cls, columns: Mapping[str, Any],
                    valid: Optional[Any] = None,
                    schema: Optional[Schema] = None) -> "Table":
        cols = {k: _as_tensor(v) for k, v in columns.items()}
        first = next(iter(cols.values()))
        n = first.shape[0]
        if valid is None:
            valid = torch.ones((n,), dtype=torch.bool, device=first.device)
        else:
            valid = _as_tensor(valid, first.device)
        if schema is None:
            schema = Schema(tuple(ColumnSchema(k, v.dtype)
                                  for k, v in cols.items()))
        return cls(cols, valid, schema)

    def to(self, device: Any) -> "Table":
        """The same table on ``device`` (no copy when already there)."""
        device = torch.device(device)
        return Table({k: v.to(device) for k, v in self.columns.items()},
                     self.valid.to(device), self.schema)

    # -- accessors ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def capacity(self) -> int:
        """Physical row count (allocated slots, live or dead)."""
        return int(self.valid.shape[0])

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.columns)

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dtype=torch.int32)

    def with_columns(self, new: Mapping[str, Any],
                     fields: Optional[Sequence[ColumnSchema]] = None
                     ) -> "Table":
        cols = dict(self.columns)
        schema = self.schema
        new = {k: _as_tensor(v, self.device) for k, v in new.items()}
        fields = list(fields) if fields is not None else [
            ColumnSchema(k, v.dtype) for k, v in new.items()]
        for f, (k, v) in zip(fields, new.items()):
            cols[k] = v
            schema = schema.with_column(f)
        return Table(cols, self.valid, schema)

    def with_valid(self, valid: torch.Tensor) -> "Table":
        return Table(self.columns, valid, self.schema)

    def row_slice(self, start: int, stop: int) -> "Table":
        """Contiguous row range ``[start, stop)`` (columns + validity mask);
        the partition accessor for partitioned scans."""
        cols = {k: v[start:stop] for k, v in self.columns.items()}
        return Table(cols, self.valid[start:stop], self.schema)

    def select(self, names: Sequence[str]) -> "Table":
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"columns {missing} not in table {self.names}")
        return Table({n: self.columns[n] for n in names}, self.valid,
                     self.schema.select(names))

    def concat_rows(self, batch: "Table") -> "Table":
        """This table's rows followed by ``batch``'s rows — the append-ingest
        primitive (``ModelStore.append_rows``).  The schemas must agree
        column-for-column: same names, same dtypes, and for
        dictionary-encoded columns the *same dictionary*, so the appended
        codes mean what the prefix codes mean.  The result keeps this
        table's schema and device; the prefix rows are bit-identical to
        this table's."""
        if sorted(self.columns) != sorted(batch.columns):
            raise ValueError(
                f"append schema mismatch: have {sorted(self.columns)}, "
                f"batch has {sorted(batch.columns)}")
        for name in self.columns:
            mine = self.schema.field(name)
            theirs = batch.schema.field(name)
            if mine.dictionary != theirs.dictionary:
                raise ValueError(
                    f"column {name!r}: dictionary mismatch — appended rows "
                    f"must be encoded with the base table's dictionary")
            if self.columns[name].dtype != batch.columns[name].dtype:
                raise ValueError(
                    f"column {name!r}: dtype {batch.columns[name].dtype} "
                    f"!= base dtype {self.columns[name].dtype}")
        dev = self.device
        cols = {name: torch.cat([self.columns[name],
                                 batch.columns[name].to(dev)])
                for name in self.columns}
        valid = torch.cat([self.valid, batch.valid.to(dev)])
        return Table(cols, valid, self.schema)

    # -- materialization (host side) ----------------------------------------
    def to_pydict(self, decode: bool = True) -> Dict[str, list]:
        valid = to_numpy(self.valid)
        out: Dict[str, list] = {}
        for name in self.columns:
            arr = to_numpy(self.columns[name])[valid]
            field = self.schema.field(name)
            if decode and field.is_categorical:
                arr = field.decode(arr)
            out[name] = arr.tolist()
        return out

    def to_numpy(self, names: Optional[Sequence[str]] = None,
                 compact: bool = True) -> np.ndarray:
        """Dense float32 feature matrix (rows x columns)."""
        names = list(names or self.names)
        mat = np.stack([to_numpy(self.columns[n]).astype(np.float32)
                        for n in names], axis=1)
        if compact:
            mat = mat[to_numpy(self.valid)]
        return mat

    def __repr__(self):
        cols = ", ".join(f"{n}:{v.dtype}" for n, v in self.columns.items())
        return f"Table[{self.capacity} rows on {self.device}]({cols})"
