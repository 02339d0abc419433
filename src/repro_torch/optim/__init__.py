"""Optimizers and learning-rate schedules of the port (mirrors
``repro/optim``): AdamW with f32 moments and the warm-up/cosine
schedule."""
from .adamw import AdamWState, adamw_update, global_norm, init_adamw
from .schedule import constant, warmup_cosine

__all__ = ["AdamWState", "adamw_update", "constant", "global_norm",
           "init_adamw", "warmup_cosine"]
