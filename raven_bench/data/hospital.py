"""Fig 1's hospital tables, frozen here so that a change to the program's
own generator cannot change what the benchmark measures.

A copy of ``repro_torch.data.synthetic.hospital_tables`` that returns plain
numpy columns: the same seed gives the same values as the program's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

TABLES = {
    "patient_info": ("pid", "age", "gender", "pregnant", "rcount",
                     "length_of_stay"),
    "blood_tests": ("pid", "hematocrit", "neutrophils", "bp"),
    "prenatal_tests": ("pid", "gestation", "fetal_hr"),
}


def generate(n: int, seed: int) -> Dict[str, Dict[str, np.ndarray]]:
    """patient_info, blood_tests and prenatal_tests of ``n`` patients,
    joined on pid (0 .. n-1 in every table)."""
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
    los = (2.0
           + 0.06 * np.maximum(age - 35, 0)
           + 1.5 * rcount
           + 0.04 * np.maximum(bp - 140, 0)
           + np.where(pregnant == 1, 1.0 + 0.05 * gestation, 0.0)
           + 0.03 * np.maximum(55 - hematocrit, 0)
           + rng.normal(0, 0.8, n))
    length_of_stay = np.maximum(los, 0.5).astype(np.float32)
    cols = locals()
    return {t: {c: cols[c] for c in names} for t, names in TABLES.items()}
