"""Training: optimizer, state and step, loop, checkpointing."""

from .optimizer import AdamWConfig, adamw_init, adamw_update, wsd_schedule
from .train_state import init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "wsd_schedule",
           "init_train_state", "make_train_step"]
