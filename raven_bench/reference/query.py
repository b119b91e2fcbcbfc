"""The plain reference of a query's answer, and its comparison with the
program's answer.

A traffic mix describes each query twice: as the SQL the program is sent,
and as an ``expect`` block this module evaluates in numpy over the same
rows: a conjunction of filters, then one of three shapes.

- ``rows``: one output row per input row, in input order, valid where the
  filters hold (``columns`` maps each output column to its source).
- ``group_avg``: one row per distinct ``key`` among the rows that pass,
  with the mean of ``avg``'s source over them.
- ``top_k``: the ``k`` rows that pass with the largest ``order`` source,
  in descending order (ties in any order), ``key`` naming each.

A source is an input column or a model output (``predict``, ``proba``).  A
filter is ``[source, op, value]`` with ``value`` a literal or ``:name``, a
bound parameter.  ``check`` returns the rows compared, the rows wrong (any
validity, key, ordering or membership fault, or a model value more than
``tol`` from the reference) and, for ``group_avg``, the widest relative gap
of a group mean.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, Mapping

import numpy as np

MODEL_SOURCES = ("predict", "proba")
OPS = {">=": operator.ge, ">": operator.gt, "<=": operator.le,
        "<": operator.lt, "=": operator.eq, "!=": operator.ne}


def bound(value: Any, binding: Mapping[str, Any]) -> Any:
    if isinstance(value, str) and value.startswith(":"):
        return binding[value[1:]]
    return value


def mask(expect: Dict, binding: Mapping[str, Any],
         ref: Mapping[str, np.ndarray], n: int) -> np.ndarray:
    keep = np.ones(n, bool)
    for src, op, value in expect.get("filter", []):
        keep &= OPS[op](ref[src], bound(value, binding))
    return keep


def _close(got: np.ndarray, want: np.ndarray, src: str, tol: float
           ) -> np.ndarray:
    if src in MODEL_SOURCES:
        return np.abs(got.astype(np.float64) - want) <= tol
    return got == want


def check(expect: Dict, binding: Mapping[str, Any],
          ref: Mapping[str, np.ndarray], out: Mapping[str, np.ndarray],
          tol: float, cache: Dict = None) -> Dict[str, float]:
    """Compare the program's answer ``out`` (host columns plus ``valid``)
    with the reference over ``ref`` (host columns and model outputs of the
    rows the request read, in order).  ``cache`` keeps what depends on
    ``ref`` alone between requests over the same ``ref``."""
    cache = {} if cache is None else cache
    n = len(ref[next(iter(ref))])
    keep = mask(expect, binding, ref, n)
    valid = np.asarray(out["valid"], bool)
    kind = expect["kind"]
    res: Dict[str, float] = {"rows": 0, "wrong": 0}
    if kind == "rows":
        if valid.shape[0] != n:
            res.update(rows=n, wrong=n)
            return res
        seen = keep | valid
        bad = keep != valid
        for name, src in expect["columns"].items():
            ok = _close(np.asarray(out[name]), ref[src], src, tol)
            bad |= keep & valid & ~ok
        res.update(rows=int(seen.sum()), wrong=int((seen & bad).sum()))
        return res
    if kind == "group_avg":
        (kname, ksrc), (aname, asrc) = expect["key"], expect["avg"]
        if ("codes", ksrc) not in cache:
            cache["codes", ksrc] = np.unique(ref[ksrc], return_inverse=True)
        uniq, codes = cache["codes", ksrc]
        kc = codes.reshape(-1)[keep]
        counts = np.bincount(kc, minlength=len(uniq))
        sums = np.bincount(kc, weights=ref[asrc][keep], minlength=len(uniq))
        present = counts > 0
        want_keys = uniq[present]
        want = sums[present] / counts[present]
        got_keys = np.asarray(out[kname])[valid]
        got = np.asarray(out[aname], np.float64)[valid]
        uniq, counts = np.unique(got_keys, return_counts=True)
        dup = int((counts - 1).sum())
        common, gi, wi = np.intersect1d(got_keys, want_keys,
                                        return_indices=True)
        missing = len(want_keys) - len(common)
        extra = len(uniq) - len(common)
        res.update(rows=len(want_keys) + extra + dup,
                   wrong=missing + extra + dup)
        if len(common):
            res["avg_gap"] = float(np.max(
                np.abs(got[gi] - want[wi]) / np.maximum(np.abs(want[wi]),
                                                        1e-30)))
        return res
    if kind == "top_k":
        (kname, ksrc), (oname, osrc) = expect["key"], expect["order"]
        k = int(expect["k"])
        cand = ref[osrc][keep]
        k_eff = min(k, len(cand))
        kth = np.partition(cand, len(cand) - k_eff)[len(cand) - k_eff] \
            if k_eff else np.inf
        got_keys = np.asarray(out[kname])[valid]
        got = np.asarray(out[oname], np.float64)[valid]
        if ("pos", ksrc) not in cache:
            key_col = np.asarray(ref[ksrc]).astype(np.int64)
            pos = np.full(int(key_col.max()) + 2, -1, np.int64)
            pos[key_col] = np.arange(n)
            cache["pos", ksrc] = pos
        pos = cache["pos", ksrc]
        gk = np.asarray(got_keys, np.int64)
        inside = (gk >= 0) & (gk < len(pos) - 1)
        row = np.where(inside, pos[np.where(inside, gk, len(pos) - 1)], -1)
        member = (row >= 0) & keep[np.maximum(row, 0)]
        _, first = np.unique(gk, return_index=True)
        distinct = np.zeros(len(gk), bool)
        distinct[first] = True
        want = np.where(member, ref[osrc][np.maximum(row, 0)], np.nan)
        close = member & (np.abs(got - want) <= tol)
        in_top = member & (want >= kth - tol)
        ordered = np.ones(len(got), bool)
        ordered[1:] = got[1:] <= got[:-1]
        ok = member & distinct & close & in_top & ordered
        short = abs(len(gk) - k_eff)
        res.update(rows=max(len(gk), k_eff), wrong=int((~ok).sum()) + short)
        return res
    raise ValueError(f"unknown expect kind {kind!r}")


def answer(expect: Dict, binding: Mapping[str, Any],
           ref: Mapping[str, np.ndarray], dtype) -> Dict[str, np.ndarray]:
    """The reference's own answer, laid out as the program's (full-length
    columns and ``valid`` for ``rows``; one row a group; the top ``k`` in
    order), its means summed in ``dtype`` (a torch dtype)."""
    import torch
    n = len(ref[next(iter(ref))])
    keep = mask(expect, binding, ref, n)
    kind = expect["kind"]
    if kind == "rows":
        out = {name: np.asarray(ref[src])
               for name, src in expect["columns"].items()}
        out["valid"] = keep
        return out
    if kind == "group_avg":
        (kname, ksrc), (aname, asrc) = expect["key"], expect["avg"]
        keys, inverse = np.unique(ref[ksrc][keep], return_inverse=True)
        vals = torch.as_tensor(ref[asrc][keep]).to(dtype)
        sums = torch.zeros(len(keys), dtype=dtype).index_add_(
            0, torch.as_tensor(inverse), vals)
        counts = torch.as_tensor(np.bincount(inverse,
                                             minlength=len(keys))).to(dtype)
        return {kname: keys, aname: (sums / counts).double().numpy(),
                "valid": np.ones(len(keys), bool)}
    if kind == "top_k":
        (kname, ksrc), (oname, osrc) = expect["key"], expect["order"]
        rows = np.nonzero(keep)[0]
        order = np.argsort(-ref[osrc][rows], kind="stable")
        top = rows[order[:int(expect["k"])]]
        return {kname: np.asarray(ref[ksrc])[top],
                oname: np.asarray(ref[osrc])[top],
                "valid": np.ones(len(top), bool)}
    raise ValueError(f"unknown expect kind {kind!r}")
