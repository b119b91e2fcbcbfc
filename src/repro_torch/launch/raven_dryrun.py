"""Raven inference-query dry-run on the H100 production mesh (the JAX
package's ``launch/raven_dryrun.py``).

The paper's section 5(iii) observation, that SQL Server parallelizes the
scan + PREDICT pipeline by itself, made explicit at pod scale: the whole
optimized inference query (scan, join, filter, featurize, tree-GEMM
scoring), as ``core/codegen.py`` compiles it, with the table columns split
over the data axes and the ensemble's trees over ``model``.

    PYTHONPATH=src python -m repro_torch.launch.raven_dryrun \\
        [--rows-per-chip 2000000] [--multi-pod]

Writes ``<out>/raven_query__<mesh>.json`` with the roofline terms of the LM
cells (``launch.dryrun``).  The pipeline is fitted on a small host sample;
the compiled query then runs once on ``meta`` tables of one data shard's
rows (``rows_per_chip`` x chips / data shards) under
``launch.cost_analysis.CostCounter``, the tree GEMM through its kernel
wrapper's meta route.  Every operator of the plan has a meta kernel
(sorts, ``searchsorted``, the masked filters and gathers), so none is
costed by hand.  Per device: the relational work is the data shard's (the
model shards of a data shard hold the same rows); the tree GEMM's
operations split over ``model`` (each model shard scores its trees) while
each model shard still reads the rows and writes its partial scores; the
partial scores are all-reduced over ``model`` (NVLink).  The tables are
range-partitioned on ``pid``, the join key, so the joins are
partition-wise and exchange nothing.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core import (CrossOptimizer, ModelStore, OptimizerConfig,
                    compile_plan, parse_query)
from ..data import hospital_tables
from ..kernels import cost as kcost
from ..ml import Pipeline, PipelineMetadata, RandomForest, StandardScaler
from ..relational.table import Table
from .cost_analysis import CostCounter
from .mesh import make_production_mesh

__all__ = ["build_query", "abstract_tables", "main"]

FEATURES = ["age", "gender", "pregnant", "rcount", "hematocrit",
            "neutrophils", "bp"]
SQL = ("SELECT pid, PREDICT_PROBA(MODEL='los_rf') AS p "
       "FROM patient_info JOIN blood_tests ON pid "
       "JOIN prenatal_tests ON pid WHERE pregnant = 1 AND age > 30")


def build_query(n_train: int = 5000):
    """Fit the pipeline on a small host sample (on the CPU) and optimize
    the query with its forest translated to the tree GEMM's kernel ->
    (store, optimized plan, report, tables)."""
    store = ModelStore(device="cpu")
    tables = hospital_tables(n_train)
    for n, t in tables.items():
        store.register_table(n, t)
    data = {c: np.asarray(t.column(c)) for t in tables.values()
            for c in t.names}
    sc = StandardScaler(FEATURES).fit(data)
    pipe = Pipeline([sc], RandomForest(n_trees=32, max_depth=8, min_leaf=10),
                    PipelineMetadata(name="los_rf", task="classification"))
    pipe.fit({k: data[k] for k in FEATURES},
             (data["length_of_stay"] > 7).astype(np.int32))
    store.register_model("los_rf", pipe)
    plan = parse_query(SQL, store)
    oplan, report = CrossOptimizer(store, OptimizerConfig(
        nn_translate_single_trees="always",
        tree_strategy="cuda")).optimize(plan)
    return store, oplan, report, tables


def abstract_tables(tables, n_rows: int):
    """``meta`` stand-ins for the scanned tables at ``n_rows`` rows."""
    return {name: Table({c: torch.empty((n_rows,), dtype=t.column(c).dtype,
                                        device="meta") for c in t.names},
                        torch.empty((n_rows,), dtype=torch.bool,
                                    device="meta"), t.schema)
            for name, t in tables.items()}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.raven_dryrun")
    ap.add_argument("--rows-per-chip", type=int, default=2_000_000)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    n_chips = mesh.size
    n_model = mesh.shape["model"]
    n_data = n_chips // n_model
    n_rows = args.rows_per_chip * n_chips
    shard_rows = n_rows // n_data

    store, oplan, report, tables = build_query()
    print("optimizer report:")
    print(report.pretty())
    fn = compile_plan(oplan, store)
    abs_tabs = abstract_tables(tables, shard_rows)
    t0 = time.time()
    with CostCounter() as counter:
        out = fn(abs_tabs)
    dt = time.time() - t0
    c = counter.cost
    gemm = c.kernels.get("tree_gemm")
    if gemm is None:
        raise RuntimeError("raven_dryrun: the plan did not reach the tree "
                           "GEMM kernel's wrapper")
    flops = c.flops - gemm["flops"] * (1 - 1 / n_model)
    n_out = out.columns["p"].shape[1] if out.columns["p"].dim() == 2 else 1
    coll = {"all-reduce": 4.0 * shard_rows * n_out} if n_model > 1 else {}
    gemm_s = sum(n / kcost.PEAKS[cls] for cls, n in gemm["ops"].items())
    compute_s = c.compute_s() - gemm_s * (1 - 1 / n_model)
    memory_s = c.bytes / kcost.PEAK_BYTES_PER_S
    collective_s = sum(coll.values()) / kcost.NVLINK_BYTES_PER_S
    arg_bytes = sum(x.numel() * x.element_size()
                    for t in abs_tabs.values()
                    for x in list(t.columns.values()) + [t.valid])
    result = {
        "kind": "raven_inference_query",
        "mesh": ("multi" if args.multi_pod else "single")
        + f"({'x'.join(str(n) for n in mesh.sizes)})",
        "status": "ok",
        "n_chips": int(n_chips),
        "n_rows": n_rows,
        "compile_s": round(dt, 2),
        "optimizations": [f"{r}: {d}" for r, d in report.entries],
        "memory": {"argument_bytes_per_device": arg_bytes,
                   "temp_bytes_per_device": None},
        "hlo_cost_per_device": {"flops": flops, "bytes": c.bytes,
                                "collective_bytes": coll},
        "cost_source": ("torch dispatch counter over one eager run of the "
                        "compiled query on meta tables of one data shard "
                        "(launch.cost_analysis), the tree GEMM's analytic "
                        "work split over model; no HLO"),
        "cost_detail": {"flops_by_class": c.flops_by_class,
                        "kernels": c.kernels, "rows_per_device": shard_rows,
                        "hardware": "NVIDIA H100 SXM5 80GB, 700 W "
                                    "data-sheet peaks"},
        "roofline": {
            "compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max([("compute", compute_s), ("memory", memory_s),
                             ("collective", collective_s)],
                            key=lambda kv: kv[1])[0],
            "rows_per_sec_bound": n_rows / max(compute_s, memory_s,
                                               collective_s, 1e-12),
        },
    }
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "multi" if args.multi_pod else "single"
    (out_dir / f"raven_query__{tag}.json").write_text(
        json.dumps(result, indent=2))
    r = result["roofline"]
    print(f"[OK] raven query x {tag}: {n_rows/1e9:.2f}B rows, "
          f"run={dt:.1f}s dominant={r['dominant']} "
          f"compute={r['compute_s']*1e3:.1f}ms mem={r['memory_s']*1e3:.1f}ms "
          f"coll={r['collective_s']*1e3:.1f}ms "
          f"bound={r['rows_per_sec_bound']:.3g} rows/s")
    return result


if __name__ == "__main__":
    main()
