"""The one traffic generator: turns a mix's data file into each client's
sequence of requests, from the seed.

A role's clients each get a cycle that holds every query of the mix as
many times as its ``weight`` says, in an order drawn from the seed.  A
size-like parameter (a cohort's width, a request's rows, a threshold) is
drawn by stratified sampling within the cycle: the cycle's draws of one
query are (i + v) / c of the distribution for i = 0 .. c-1 in a shuffled
order, v uniform in [0, 1), so every seed and every client covers the same
spread of sizes and the seed changes their order and where each lands.
Clients repeat their cycle, each time with new draws.  A ``uniform``
threshold is drawn over the ``domain`` its mix states for the column, as
TPC-H draws substitution parameters, never over the seed's data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping

import numpy as np


@dataclasses.dataclass
class Request:
    role: str
    client: int
    index: int                   # n-th request of this client
    query: Dict[str, Any]        # the mix's entry
    binding: Dict[str, Any]      # SQL parameters
    rows: tuple = ()             # (start, count) of the pool, for tables
    input_rows: int = 0


def seed_rng(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *words]))


def _quantiles(rng: np.random.Generator, c: int) -> np.ndarray:
    return (rng.permutation(c) + rng.random(c)) / c


def _log_uniform(u: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return lo * (hi / lo) ** u


def _draw(query: Mapping, us: Dict[str, float], rng: np.random.Generator,
          info: Mapping, scale: float) -> tuple:
    """(binding, pool rows) of one request of ``query``."""
    binding: Dict[str, Any] = {}
    rows: tuple = ()
    for i, p in enumerate(query.get("params", [])):
        u = us[i]
        if p["kind"] == "range":
            lo_v, hi_v = info["ranges"][p["column"]]
            span = int(hi_v) - int(lo_v) + 1
            w_lo, w_hi = (max(1, int(round(x * scale))) for x in p["width"])
            width = min(span, int(round(_log_uniform(u, w_lo, w_hi))))
            start = int(lo_v) + int(rng.integers(0, span - width + 1))
            binding[p["names"][0]] = start
            binding[p["names"][1]] = start + width
        elif p["kind"] == "uniform":
            lo_v, hi_v = p["domain"]
            binding[p["name"]] = float(np.float32(lo_v + u * (hi_v - lo_v)))
        elif p["kind"] == "rows":
            r_lo, r_hi = (max(1, int(round(x * scale))) for x in p["rows"])
            count = min(info["pool_rows"],
                        int(round(_log_uniform(u, r_lo, r_hi))))
            start = int(rng.integers(0, info["pool_rows"] - count + 1))
            rows = (start, count)
        else:
            raise ValueError(f"unknown parameter kind {p['kind']!r}")
    return binding, rows


def requests(role: Mapping, client: int, seed: int, role_no: int,
             info: Mapping, scale: float = 1.0) -> Iterator[Request]:
    """The endless request sequence of one client of ``role``.  ``info``
    holds ``ranges`` (column -> (min, max), for ``range`` widths),
    ``anchor_rows`` and ``pool_rows``."""
    rng = seed_rng(seed, 1, role_no, client)
    mix = role["mix"]
    n = 0
    while True:
        order: List[int] = [q for q, m in enumerate(mix)
                            for _ in range(int(m["weight"]))]
        order = [order[i] for i in rng.permutation(len(order))]
        draws = {q: [_quantiles(rng, int(m["weight"]))
                     for _ in m.get("params", [])]
                 for q, m in enumerate(mix)}
        seen = {q: 0 for q in range(len(mix))}
        for q in order:
            k = seen[q]
            seen[q] += 1
            us = {i: float(d[k]) for i, d in enumerate(draws[q])}
            binding, rows = _draw(mix[q], us, rng, info, scale)
            yield Request(role["role"], client, n, mix[q], binding, rows,
                          rows[1] if rows else info["anchor_rows"])
            n += 1


def warm_buckets(role: Mapping, scale: float, min_rows: int,
                 max_rows: int) -> List[int]:
    """Every row bucket a table-sending role's stacked batches can reach:
    powers of two from the smallest request up to ``max_rows``, then
    multiples of ``max_rows`` up to all its clients' largest requests at
    once (the service's bucket policy)."""
    sizes = [max(1, int(round(x * scale)))
             for m in role["mix"] for p in m.get("params", [])
             if p["kind"] == "rows" for x in p["rows"]]
    lo, top = min(sizes), max(sizes) * int(role["clients"])
    out, b = [], max(1, min_rows)
    while b < lo:
        b <<= 1
    while b < min(top, max_rows):
        out.append(b)
        b <<= 1
    out.append(min(b, max_rows))
    m = max_rows
    while m < top:
        m += max_rows
        out.append(m)
    return sorted(set(out))
