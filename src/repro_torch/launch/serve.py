"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The JAX package's ``launch/serve.py``: the continuous-batching engine over
synthetic requests, reporting throughput and TTFT percentiles in the same
two lines. Its flags and defaults are the JAX launcher's. ``--reduced`` is
a ``store_true`` flag whose default is True there, so the JAX launcher
always serves the reduced config; this one keeps that, at the kernels' head
size (``configs.kernel_reduced_config``). It serves on the card (``--device
cuda``, the default, raises without one) unless ``--device cpu`` is given.
Parameters are random, drawn from seed 0.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np


def launch_config(arch: str, reduced: bool):
    """The arch's config, or its reduced config at the kernels' head
    size."""
    from ..configs import get_config, kernel_reduced_config
    cfg = get_config(arch)
    return kernel_reduced_config(cfg) if reduced else cfg


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..models import build_model
    from ..serve import InferenceEngine, Request, ServeConfig

    cfg = launch_config(args.arch, args.reduced)
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init_params(gen)
    engine = InferenceEngine(model, ServeConfig(
        n_slots=args.slots,
        max_len=args.prompt_len + args.new_tokens + 8,
        eos_token=-1))
    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        engine.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens))
    engine.run_until_drained(params)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    done = engine.completed
    toks = sum(len(r.output) for r in done)
    ttft = sorted(1e3 * (r.first_token_at - r.submitted_at) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks/wall:.1f} tok/s)")
    print(f"TTFT p50={ttft[len(ttft)//2]:.0f}ms p95="
          f"{ttft[int(len(ttft)*0.95)]:.0f}ms")
    return {"requests": len(done), "tokens": toks, "wall_s": wall,
            "prefills": engine.prefills, "decode_steps": engine.decode_steps,
            "device": str(model.device)}


if __name__ == "__main__":
    main()
