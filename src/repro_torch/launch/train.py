"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The JAX package's ``launch/train.py`` on one device, with its flags and
defaults: sequence length 256, batch 8, peak learning rate 3e-3, the WSD
schedule for ``minicpm-2b`` (cosine otherwise) with warmup max(steps / 20,
5) and decay over the run, layer remat unless ``--reduced``.  It trains on
the card (``--device cuda``, the default, raises without one) unless
``--device cpu`` is given.  ``--reduced`` trains the arch's reduced config
at the kernels' head size (``configs.kernel_reduced_config``: ``d_head``
64, where the JAX package's reduced configs use 16).  ``--mesh`` is
accepted with the JAX package's choices and, as there, changes nothing.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-size) config")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train"))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", choices=["none", "local"], default="none",
                    help="accepted for the JAX launcher's command lines; "
                         "no effect")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from ..configs import ShapeConfig, get_config, kernel_reduced_config
    from ..models import build_model
    from ..train.loop import TrainLoopConfig, train
    from ..train.optimizer import AdamWConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = kernel_reduced_config(cfg)
    model = build_model(cfg, device=args.device, remat=not args.reduced)
    shape = ShapeConfig("cli", "train", args.seq_len, args.batch)
    schedule = "wsd" if args.arch == "minicpm-2b" else "cosine"
    stats = train(model, shape, TrainLoopConfig(
        n_steps=args.steps, ckpt_root=args.ckpt, grad_accum=args.grad_accum,
        opt=AdamWConfig(peak_lr=args.lr, schedule=schedule,
                        warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)))
    print(f"done: {stats['steps_run']} steps, {stats['restarts']} restarts, "
          f"{stats['wall_s']:.1f}s on {model.device}", flush=True)
    return stats


if __name__ == "__main__":
    main()
