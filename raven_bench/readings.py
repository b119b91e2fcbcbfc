"""Readings of the correctness check over many seeds in one process, on
the card: the program's and the sound stand-in's (``fold32``: the
reference in float32 with its scaler folded into the model), the lower
readings of each limit, or the control's, the reference in bfloat16 put in
the program's place (the upper readings).  One JSON line a seed.  The
benchmark's own runs never run this.

    python3 raven_bench/readings.py --workload <name> --program control \
        --seconds 5 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

from run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", choices=("program", "control", "fold32"),
                    required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from raven_bench.harness.cell import run_cell
    from raven_bench.harness.control import ControlProgram
    program = {"program": None, "control": ControlProgram,
               "fold32": functools.partial(ControlProgram,
                                           dtype=torch.float32, fold=True)
               }[args.program]
    for seed in args.seeds:
        t = time.monotonic()
        r = run_cell(args.workload, seed, args.seconds, False, t,
                     program=program,
                     log=lambda s: print(s, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.program, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
