"""The flights table of Raven's Fig 2a, frozen here so that a change to the
program's own generator cannot change what the benchmark measures.

A copy of ``repro_torch.data.synthetic.flight_features`` (the label is
dropped: the benchmark serves a model, it fits none), shaped after the
Kaggle "2015 Flight Delays and Cancellations" data (US DOT).  The same
arguments give the same columns as the program's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

TABLES = {"flights": ("origin", "dest", "carrier", "dow", "dep_hour",
                      "distance", "taxi_out")}


def generate(n: int, seed: int, n_airports: int = 40, n_carriers: int = 12,
             n_regions: int = 5) -> Dict[str, Dict[str, np.ndarray]]:
    """One table, ``flights``, of ``n`` rows.  Airports belong to regions,
    most flights stay in their region, and carriers are regional."""
    rng = np.random.default_rng(seed)
    per_region = n_airports // n_regions
    region = rng.integers(0, n_regions, n)
    origin = (region * per_region
              + rng.integers(0, per_region, n)).astype(np.int32)
    same = rng.random(n) < 0.85
    dest_region = np.where(same, region, rng.integers(0, n_regions, n))
    dest = (dest_region * per_region
            + rng.integers(0, per_region, n)).astype(np.int32)
    carriers_per_region = max(n_carriers // n_regions, 1)
    regional_carrier = rng.random(n) < 0.8
    carrier = np.where(
        regional_carrier,
        region * carriers_per_region
        + rng.integers(0, carriers_per_region, n),
        rng.integers(0, n_carriers, n)).astype(np.int32)
    dow = rng.integers(0, 7, n).astype(np.int32)
    dep_hour = rng.integers(0, 24, n).astype(np.int32)
    distance = rng.uniform(100, 3000, n).astype(np.float32)
    taxi_out = rng.normal(15, 5, n).astype(np.float32)
    return {"flights": {"origin": origin, "dest": dest, "carrier": carrier,
                        "dow": dow, "dep_hour": dep_hour,
                        "distance": distance, "taxi_out": taxi_out}}
