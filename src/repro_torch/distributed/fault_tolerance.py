"""Fault tolerance: checkpoint-restart supervision with failure injection (the
JAX package's ``distributed/fault_tolerance.py``).

The training loop (``train.loop``) runs restartable epochs over a
deterministic, seekable data stream: the state (parameters, optimizer,
step) is the only mutable thing, and it checkpoints atomically.

- ``RestartableRunner`` runs a step function under a supervision loop: on
  any exception it restores the latest checkpoint and resumes (bounded
  retries), as a cluster supervisor does across process boundaries.
- ``FailureInjector`` raises at a chosen step, deterministically, for
  tests of restart-exactly-once.
- Stragglers: the framework-level guards are the non-finite step skip
  (``train.train_state``), batch prefetch (``data.lm_data``) and the
  checkpoint cadence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from ..train.checkpoint import latest_step, restore_checkpoint, \
    save_checkpoint

__all__ = ["FailureInjector", "RestartableRunner"]


class FailureInjector:
    """Raises at ``fail_at``, at most ``n_failures`` times."""

    def __init__(self, fail_at: Optional[int] = None,
                 n_failures: int = 1):
        self.fail_at = fail_at
        self.remaining = n_failures
        self.failures_seen = 0

    def maybe_fail(self, step: int) -> None:
        if self.fail_at is not None and step == self.fail_at \
                and self.remaining > 0:
            self.remaining -= 1
            self.failures_seen += 1
            raise RuntimeError(
                f"[injected] simulated node failure at step {step}")


@dataclasses.dataclass
class RestartableRunner:
    ckpt_root: str
    ckpt_every: int = 50
    max_restarts: int = 3
    keep_last: int = 3

    def run(self, init_state_fn: Callable[[], Any],
            step_fn: Callable[[Any, int], Any],
            n_steps: int,
            injector: Optional[FailureInjector] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict:
        """Supervision loop: init or restore, step, checkpoint, restart on
        failure.  Returns run statistics (restarts, steps run, the steps
        resumed from, the final step).  A restore takes the structure and
        devices of a fresh ``init_state_fn()``."""
        restarts = 0
        stats = {"restarts": 0, "steps_run": 0, "resumed_from": []}
        while True:
            state = None          # drop a failed attempt's state first
            try:
                start = latest_step(self.ckpt_root)
                if start is None:
                    state = init_state_fn()
                    step = 0
                else:
                    state, step, _ = restore_checkpoint(self.ckpt_root,
                                                        init_state_fn())
                    stats["resumed_from"].append(step)
                while step < n_steps:
                    if injector is not None:
                        injector.maybe_fail(step)
                    state, metrics = step_fn(state, step)
                    step += 1
                    stats["steps_run"] += 1
                    if on_metrics is not None:
                        on_metrics(step, metrics)
                    if step % self.ckpt_every == 0 or step == n_steps:
                        save_checkpoint(self.ckpt_root, step, state,
                                        keep_last=self.keep_last)
                stats["final_step"] = step
                stats["restarts"] = restarts
                return stats
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                time.sleep(0.01)    # supervisor backoff (short for tests)
