"""Run one cell of the benchmark once and print its result line.

    python3 raven_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object; standard
error ends with each number the correctness check compared, beside its
limit.  With ``--trace 1`` the metrics are the cell's per-layer ones, read
from a profiled window; with ``--trace 0`` its end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "raven_bench" / "_cache"
RUNS = ROOT / "raven_bench" / "_runs"


def _environment() -> None:
    """Build caches inside the checkout, at fixed paths (the port builds
    its kernels into ``src/repro_torch/_build`` itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    t_torch = time.monotonic() - T_START
    from raven_bench.harness import layout
    chips = int(layout.workload(layout.manifest(), args.workload)["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    from raven_bench.harness.cell import run_cell

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, log=log)
    RUNS.mkdir(parents=True, exist_ok=True)
    log_ = {"workload": args.workload, "seed": args.seed,
            "trace": args.trace, "device": result["device"],
            "requests": result.pop("requests"),
            "setup_phases": {"torch": t_torch,
                             **result.pop("setup_phases")},
            "mode": result.pop("mode")}
    if args.trace:
        log_["breakdown"] = result["breakdown"]
        log_["device_seconds"] = result.pop("device_seconds")
    (RUNS / f"{args.workload}.{args.seed}.{args.trace}.json").write_text(
        json.dumps(log_))
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
