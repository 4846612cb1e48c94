from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state, opt_state_axes
from .schedules import constant_lr, warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "opt_state_axes",
    "constant_lr",
    "warmup_cosine",
]
