"""Synthetic versions of the paper's two datasets.

The paper evaluates on (i) hospital length-of-stay (running example, based on
the Microsoft LOS sample) and (ii) the Kaggle US-DOT flight-delays dataset
(offline-only here).  We generate statistically-faithful synthetic stand-ins
with the same schema roles: mixed numeric + categorical features, a label
driven by an interpretable ground-truth process (so trained trees have
meaningful structure for the pruning optimizations to exploit).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..relational.table import Table, to_numpy

__all__ = ["hospital_tables", "hospital_features", "flight_features"]


def hospital_tables(n: int = 10_000, seed: int = 0) -> Dict[str, Table]:
    """patient_info / blood_tests / prenatal_tests, joined on pid.

    Mirrors Fig 1: patient_info(pid, age, gender, pregnant, rcount),
    blood_tests(pid, hematocrit, neutrophils, bp), prenatal_tests(pid,
    gestation, fetal_hr).  length_of_stay (label) lives in patient_info.
    The tables are host (CPU) tables; ``ModelStore.register_table`` places
    them on the store's device.  Same seed, same tables as the JAX package.
    """
    rng = np.random.default_rng(seed)
    pid = np.arange(n, dtype=np.int32)
    age = rng.integers(18, 90, n).astype(np.int32)
    gender = rng.integers(0, 2, n).astype(np.int32)          # 1 = female
    pregnant = ((gender == 1) & (age < 50)
                & (rng.random(n) < 0.3)).astype(np.int32)
    rcount = rng.poisson(1.2, n).astype(np.int32)
    hematocrit = rng.normal(42, 5, n).astype(np.float32)
    neutrophils = rng.normal(60, 10, n).astype(np.float32)
    bp = rng.normal(120, 18, n).astype(np.float32)
    gestation = np.where(pregnant == 1, rng.integers(8, 40, n), 0).astype(
        np.int32)
    fetal_hr = np.where(pregnant == 1, rng.normal(140, 12, n), 0).astype(
        np.float32)

    # Ground-truth LOS process: interactions the tree can discover.
    los = (2.0
           + 0.06 * np.maximum(age - 35, 0)
           + 1.5 * rcount
           + 0.04 * np.maximum(bp - 140, 0)
           + np.where(pregnant == 1, 1.0 + 0.05 * gestation, 0.0)
           + 0.03 * np.maximum(55 - hematocrit, 0)
           + rng.normal(0, 0.8, n))
    length_of_stay = np.maximum(los, 0.5).astype(np.float32)

    patient_info = Table.from_pydict({
        "pid": pid, "age": age, "gender": gender, "pregnant": pregnant,
        "rcount": rcount, "length_of_stay": length_of_stay,
    })
    blood_tests = Table.from_pydict({
        "pid": pid, "hematocrit": hematocrit, "neutrophils": neutrophils,
        "bp": bp,
    })
    prenatal_tests = Table.from_pydict({
        "pid": pid, "gestation": gestation, "fetal_hr": fetal_hr,
    })
    return {"patient_info": patient_info, "blood_tests": blood_tests,
            "prenatal_tests": prenatal_tests}


def hospital_features(n: int = 10_000, seed: int = 0
                      ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Flat featurized view + binary label (stay > 7 days)."""
    tables = hospital_tables(n, seed)
    cols: Dict[str, np.ndarray] = {}
    for t in tables.values():
        for name in t.names:
            cols[name] = to_numpy(t.column(name))
    label = (cols.pop("length_of_stay") > 7.0).astype(np.int32)
    cols.pop("pid")
    return cols, label


def flight_features(n: int = 10_000, seed: int = 1, n_airports: int = 40,
                    n_carriers: int = 12, n_regions: int = 5
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Synthetic flight-delay dataset (categorical-heavy, like the Kaggle
    original): origin/dest airports and carrier are categoricals that one-hot
    into wide, sparse features — the shape the paper's one-hot pruning and
    projection-pushdown experiments need.

    Air traffic is *regional* (like the real network): airports belong to
    regions (contiguous code ranges), most flights stay in-region, and
    carriers are region-dominant.  This is the data-property structure the
    paper's model-clustering optimization discovers (Fig 2b): a k-means
    cluster pins origin/dest/carrier into narrow ranges, so most one-hot
    features become provably constant inside the cluster.
    """
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

    # Delay process: a few airports/carriers are chronically delayed; evening
    # departures and long taxi-out add risk.  Most one-hot features are
    # irrelevant -> L1 models become sparse (paper Fig 2a setting).
    airport_effect = np.zeros(n_airports)
    airport_effect[: n_airports // 8] = 1.5
    carrier_effect = np.zeros(n_carriers)
    carrier_effect[:2] = 1.0
    logit = (-2.0
             + airport_effect[origin] + 0.5 * airport_effect[dest]
             + carrier_effect[carrier]
             + 0.08 * np.maximum(dep_hour - 15, 0)
             + 0.05 * np.maximum(taxi_out - 20, 0))
    delayed = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)

    cols = {"origin": origin, "dest": dest, "carrier": carrier, "dow": dow,
            "dep_hour": dep_hour, "distance": distance, "taxi_out": taxi_out}
    return cols, delayed
