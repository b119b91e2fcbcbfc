"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device   — the card (``nvidia-smi`` name and power limit), torch and
               CUDA versions; TF32 is switched off for matmuls and cuDNN.
2. build    — compiles every kernel of the path from ``src/repro_torch/csrc``
               with ``nvcc`` (one process per source, all started together).
3. kernels  — each kernel against its plain torch version on the card, at
               the main path's shapes and on edge cases (ragged rows,
               NaN/±inf, one tree); max |difference| must be 0.  Times the
               kernel and the plain version with CUDA events.
4. main     — the port's main path, as a user drives it: a ``ModelStore``
               on the card holding the hospital tables at 1,000,000 patients
               each, a 64-tree depth-8 random forest over quickstart's seven
               features, and three SQL ``PREDICT`` queries, each optimized
               with the tree strategy forced to traversal, dense GEMM, the
               CUDA kernel, and left to the measured crossover ("auto").
               The forced strategies must agree bitwise; the kernel's launch
               count must rise.
5. check    — query (a) run on the card equals the same query run by the
               port on the CPU with traversal, bitwise.

Then one ``{"kernels": [...]}`` line, and last ``{"ok": true, "device":
{...}}``.  The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS = 1_000_000          # patients per table
N_TREES, DEPTH = 64, 8
FIT_ROWS = 50_000
FEATURES = ["age", "gender", "pregnant", "rcount", "hematocrit",
            "neutrophils", "bp"]
# Query (a) joins blood_tests: three of the seven features live there.
# The grammar takes only a column inside an aggregate, so (c) names the
# PREDICT_PROBA column by its placeholder, registered through WHERE.
QUERIES = {
    "a": "SELECT pid, PREDICT(MODEL='rf') AS s FROM patient_info "
         "JOIN blood_tests ON pid",
    "b": "SELECT pid, age, PREDICT(MODEL='rf') AS s FROM patient_info "
         "JOIN blood_tests ON pid JOIN prenatal_tests ON pid "
         "WHERE pregnant = 1 AND PREDICT(MODEL='rf') > 0",
    "c": "SELECT gender, AVG(__pred_0_rf) AS p FROM patient_info "
         "JOIN blood_tests ON pid WHERE PREDICT_PROBA(MODEL='rf') >= 0 "
         "GROUP BY gender",
}
STRATEGIES = ("traversal", "gemm", "cuda", "auto")
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 on CUDA cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, warmup: int = 2, runs: int = 5) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 1 -------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})


# -- phase 2 -------------------------------------------------------------------

def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.tree_gemm import tree_gemm as tg_build
    builders = {"tree_gemm": tg_build.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {k: pool.submit(fn) for k, fn in builders.items()}
        libs = {k: str(f.result().relative_to(ROOT))
                for k, f in futures.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs})


# -- phase 3 -------------------------------------------------------------------

def tree_gemm_bound_ms(x, ens) -> tuple:
    """Least time for this call: float32 operations over the CUDA-core peak,
    or each input read once and the output written once over HBM bandwidth,
    whichever is larger."""
    n, f = x.shape
    t, _, i = ens.a.shape
    l, o = ens.c.shape[2], ens.e.shape[2]
    flops = 2.0 * n * t * (f * i + i * l + l * o)
    nbytes = 4.0 * (x.numel() + sum(getattr(ens, k).numel() for k in "abcde")
                    + n * o)
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes")


def compare_tree_gemm(ens_dev, x) -> float:
    """Kernel vs plain version on the same card inputs -> max |diff|.  The
    plain side repeats the wrapper's input mapping and averaging."""
    import numpy as np
    import torch

    from repro_torch.kernels.tree_gemm import ops as tg_ops
    from repro_torch.kernels.tree_gemm.ref import tree_gemm_ref
    got = tg_ops.tree_gemm(ens_dev, x)
    xm = torch.nan_to_num(x, nan=tg_ops._FMAX, posinf=tg_ops._FMAX,
                          neginf=-tg_ops._FMAX)
    want = tree_gemm_ref(xm, ens_dev.a, ens_dev.b, ens_dev.c, ens_dev.d,
                         ens_dev.e)
    if ens_dev.average:
        want = want * float(np.float32(1.0) / np.float32(ens_dev.n_trees))
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"tree_gemm output {tuple(got.shape)} not finite/shaped "
             f"like {tuple(want.shape)}")
    return float((got - want).abs().max())


def phase_kernels(ens, ens_pad8, x_main):
    """tree_gemm against its plain version: edge cases (ragged rows,
    NaN/±inf, one tree, I and L not multiples of the kernel's tiles), then
    the main path's shape (the plan's ensemble on query (a)'s features),
    timed."""
    import numpy as np
    import torch

    from repro_torch.kernels.tree_gemm.ref import tree_gemm_ref
    from repro_torch.ml.hummingbird import EnsembleGemm
    dev = x_main.device
    rng = np.random.default_rng(1)
    one_tree = EnsembleGemm(ens.a[:1], ens.b[:1], ens.c[:1], ens.d[:1],
                            ens.e[:1], n_trees=1, average=True,
                            feat=ens.feat[:1])
    cases = []
    for n in (1, 63, 65, 1001, 100_003):
        x = x_main[:n].clone()
        poison = torch.from_numpy(rng.random(tuple(x.shape))).to(dev)
        x[poison < 0.02] = float("nan")
        x[poison > 0.99] = float("inf")
        x[(poison > 0.5) & (poison < 0.51)] = float("-inf")
        cases.append((f"ragged_nan_inf_n{n}", ens, x))
    cases.append(("one_tree_n4097", one_tree, x_main[:4097]))
    cases.append(("pad8_n70001", ens_pad8, x_main[:70_001]))
    cases.append(("main_path", ens, x_main))
    worst = 0.0
    for name, e, x in cases:
        err = compare_tree_gemm(e.to_device(dev), x)
        emit({"phase": "kernels", "kernel": "tree_gemm", "case": name,
              "shape": {"x": list(x.shape), "a": list(e.a.shape),
                        "c": list(e.c.shape), "e": list(e.e.shape)},
              "max_abs_err": err})
        worst = max(worst, err)
    if worst != 0.0:
        fail(f"tree_gemm disagrees with its plain version: {worst}")

    from repro_torch.kernels.tree_gemm import ops as tg_ops
    dens = ens.to_device(dev)
    xm = torch.nan_to_num(x_main, nan=tg_ops._FMAX, posinf=tg_ops._FMAX,
                          neginf=-tg_ops._FMAX)
    ms = cuda_ms(lambda: tg_ops.tree_gemm(dens, x_main))
    plain_ms = cuda_ms(lambda: tree_gemm_ref(xm, dens.a, dens.b, dens.c,
                                             dens.d, dens.e))
    bound_ms, bound_by = tree_gemm_bound_ms(x_main, dens)
    row = {"name": "tree_gemm", "route": "cuda",
           "source": "src/repro_torch/csrc/tree_gemm.cu",
           "replaces": "src/repro/kernels/tree_gemm/tree_gemm.py:75",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           # no single PyTorch call computes this function
           "library_ms": None}
    emit({"phase": "kernels", "kernel": "tree_gemm", "timing": row,
          "x": list(x_main.shape)})
    return row


# -- phases 4 and 5 ------------------------------------------------------------

def setup_model(tables):
    """The 64-tree forest, fitted with the port's numpy CART on the first
    50,000 patients (label: stay longer than 7 days)."""
    import numpy as np

    from repro_torch.ml import (Pipeline, PipelineMetadata, RandomForest,
                                StandardScaler)
    from repro_torch.relational.table import to_numpy
    data = {c: to_numpy(t.column(c))[:FIT_ROWS]
            for t in tables.values() for c in t.names}
    pipe = Pipeline([StandardScaler(FEATURES).fit(data)],
                    RandomForest(n_trees=N_TREES, max_depth=DEPTH),
                    PipelineMetadata(name="rf", task="classification"))
    t0 = time.perf_counter()
    pipe.fit({k: data[k] for k in FEATURES},
             (data["length_of_stay"] > 7.0).astype(np.int32))
    return pipe, time.perf_counter() - t0


def strategy_of(plan) -> str:
    return next((n.attrs.get("strategy", "gemm") for n in plan.nodes.values()
                 if n.op == "tree_gemm"), "traversal")


def run_query(store, sql, strategy, timed_runs=3):
    """Optimize with the strategy forced (or "auto"), compile, run once to
    warm and count kernel launches, time ``timed_runs`` runs, and run once
    more op by op (codegen's ``node_hook``, which synchronizes the card
    around every node) for the per-operator breakdown."""
    import torch

    from repro_torch.core import (CrossOptimizer, OptimizerConfig,
                                  compile_plan, parse_query)
    from repro_torch.kernels.tree_gemm import ops as tg_ops
    t0 = time.perf_counter()
    plan, _report = CrossOptimizer(store, OptimizerConfig(
        tree_strategy=strategy)).optimize(parse_query(sql, store))
    fn = compile_plan(plan, store)
    plan_ms = (time.perf_counter() - t0) * 1e3
    tabs = {n: store.get_table(n) for n in store.table_names()}
    before = tg_ops.launches
    out = fn(tabs)
    torch.cuda.synchronize()
    launches = tg_ops.launches - before
    times = []
    for _ in range(timed_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(tabs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ops_ms = {}

    def hook(nid, node, value, elapsed_s):
        ops_ms[node.op] = ops_ms.get(node.op, 0.0) + elapsed_s * 1e3

    compile_plan(plan, store, node_hook=hook)(tabs)
    return out, {"chosen": strategy_of(plan), "plan_ms": plan_ms,
                 "ms": statistics.median(times), "ms_runs": times,
                 "launches_per_run": launches,
                 "ops_ms": dict(sorted(ops_ms.items(),
                                       key=lambda kv: -kv[1]))}


def host(table):
    from repro_torch.relational.table import to_numpy
    return {"valid": to_numpy(table.valid),
            **{k: to_numpy(v) for k, v in table.columns.items()}}


def same(a, b) -> bool:
    import numpy as np
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k],
                                                    equal_nan=True)
        for k in a)


def phase_main(tables, pipe):
    import numpy as np

    from repro_torch.core import ModelStore
    from repro_torch.kernels.tree_gemm import ops as tg_ops
    tg_ops.launches = 0                 # counts from here on are the path's
    t0 = time.perf_counter()
    store = ModelStore(device="cuda")
    for name, t in tables.items():
        store.register_table(name, t)
    store.register_model("rf", pipe)
    emit({"phase": "main", "step": "register", "rows": N_ROWS,
          "tables": sorted(tables), "seconds": time.perf_counter() - t0})
    outs = {}
    for q, sql in QUERIES.items():
        for strategy in STRATEGIES:
            out, info = run_query(store, sql, strategy)
            h = host(out)
            live = int(h["valid"].sum())
            for k, v in h.items():
                if v.dtype.kind == "f" and not np.isfinite(v[h["valid"]]).all():
                    fail(f"query ({q}) {strategy}: column {k} not finite")
            emit({"phase": "main", "query": q, "strategy": strategy,
                  "live_rows": live, "capacity": int(h["valid"].shape[0]),
                  **info})
            if strategy == "cuda" and info["launches_per_run"] != 1:
                fail(f"query ({q}) with strategy cuda launched tree_gemm "
                     f"{info['launches_per_run']} times, expected 1")
            outs[q, strategy] = h
        base = outs[q, "traversal"]
        for strategy in STRATEGIES[1:]:
            if not same(base, outs[q, strategy]):
                fail(f"query ({q}): {strategy} differs from traversal")
    launches = tg_ops.launches
    if launches == 0:
        fail("the main path never launched the tree_gemm kernel")
    emit({"phase": "main", "step": "agree", "queries": sorted(QUERIES),
          "strategies": list(STRATEGIES), "bitwise_equal": True,
          "tree_gemm_launches": launches})
    return outs, launches


def phase_check(tables, pipe, outs):
    """Query (a) by the port on the CPU with traversal vs the card."""
    from repro_torch.core import ModelStore
    cpu = ModelStore(device="cpu")
    for name in ("patient_info", "blood_tests"):
        cpu.register_table(name, tables[name])
    cpu.register_model("rf", pipe)
    t0 = time.perf_counter()
    from repro_torch.core import (CrossOptimizer, OptimizerConfig, execute,
                                  parse_query)
    plan, _ = CrossOptimizer(cpu, OptimizerConfig(
        tree_strategy="traversal")).optimize(parse_query(QUERIES["a"], cpu))
    want = host(execute(plan, cpu))
    equal = {s: same(want, outs["a", s]) for s in STRATEGIES}
    emit({"phase": "check", "query": "a", "cpu_traversal_vs_card": equal,
          "rows": int(want["valid"].shape[0]),
          "cpu_seconds": time.perf_counter() - t0})
    if not all(equal.values()):
        fail(f"query (a) on the card differs from the CPU: {equal}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))

    phase_device()
    phase_build()

    from repro_torch.core.rules.nn_translation import CUDA_PAD
    from repro_torch.data import hospital_tables
    from repro_torch.ml import ensemble_to_gemm
    t0 = time.perf_counter()
    tables = hospital_tables(N_ROWS)
    pipe, fit_s = setup_model(tables)
    emit({"phase": "setup", "rows": N_ROWS, "fit_rows": FIT_ROWS,
          "trees": N_TREES, "depth": DEPTH, "features": FEATURES,
          "fit_seconds": fit_s, "seconds": time.perf_counter() - t0})

    ens = ensemble_to_gemm(pipe.model.trees, pad_to=CUDA_PAD)
    ens_pad8 = ensemble_to_gemm(pipe.model.trees, pad_to=8)
    cols = {c: t.column(c).cuda() for name, t in tables.items()
            if name != "prenatal_tests" for c in t.names}
    x_main = pipe.transform(cols)          # query (a)'s features, on card
    row = phase_kernels(ens, ens_pad8, x_main)

    outs, launches = phase_main(tables, pipe)
    phase_check(tables, pipe, outs)

    emit({"kernels": [{**row, "launches": launches}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
