"""Training loop: restartable, checkpointed, metric-logged (the JAX
package's ``train/loop.py`` on one device).

Composes the model (``models``), AdamW with its schedules, the
deterministic token stream (``data.lm_data``) and checkpoint-restart
supervision (``distributed.fault_tolerance``).  Used by
``launch/train.py``.  The JAX package's ``mesh`` and ``batch_shardings``
wait for the port's ``distributed`` slice.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.lm_data import TokenStream
from ..distributed.fault_tolerance import FailureInjector, RestartableRunner
from .optimizer import AdamWConfig
from .train_state import init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    n_steps: int = 100
    ckpt_root: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    grad_accum: int = 1
    seed: int = 0
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def train(model, shape, loop_cfg: TrainLoopConfig,
          injector: Optional[FailureInjector] = None,
          on_metrics: Optional[Callable] = None) -> Dict:
    """Train ``model`` on ``TokenStream`` batches of ``shape``
    (``seq_len`` tokens, less the patch prefix for a vision model, by
    ``global_batch``) for ``loop_cfg.n_steps`` steps under a
    ``RestartableRunner``.  Parameters are drawn from a generator on the
    model's device seeded with ``loop_cfg.seed``.  Returns the runner's
    statistics plus ``wall_s`` and ``losses`` ([(step, loss)] at every
    ``log_every`` step and the last)."""
    cfg = model.cfg
    extra = {}
    if cfg.frontend == "vision_patches":
        extra["patch_embeds"] = ((cfg.n_frontend_tokens, cfg.d_model),
                                 np.float32)
    if cfg.is_encdec:
        src = max(1, int(shape.seq_len * cfg.encoder_len_ratio))
        extra["src_embeds"] = ((src, cfg.d_model), np.float32)
    text_len = shape.seq_len - (cfg.n_frontend_tokens
                                if cfg.frontend == "vision_patches" else 0)
    stream = TokenStream(cfg.vocab_size, text_len, shape.global_batch,
                         seed=loop_cfg.seed, extra_specs=extra)
    step_fn = make_train_step(model, loop_cfg.opt,
                              grad_accum=loop_cfg.grad_accum)
    losses = []

    def init_state():
        gen = torch.Generator(device=model.device)
        gen.manual_seed(loop_cfg.seed)
        return init_train_state(model, gen)

    def one_step(state, step):
        return step_fn(state, stream.batch(step))

    def metrics_hook(step, metrics):
        if step % loop_cfg.log_every == 0 or step == loop_cfg.n_steps:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            print(f"  step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if on_metrics:
            on_metrics(step, metrics)

    runner = RestartableRunner(loop_cfg.ckpt_root,
                               ckpt_every=loop_cfg.ckpt_every)
    t0 = time.time()
    stats = runner.run(init_state, one_step, loop_cfg.n_steps,
                       injector=injector, on_metrics=metrics_hook)
    stats["wall_s"] = time.time() - t0
    stats["losses"] = losses
    return stats
