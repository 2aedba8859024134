"""AdamW, its warmup-cosine schedule, global-norm clipping and gradient
accumulation; the port's counterpart of ``repro/optim``."""

from .adamw import (
    AdamWConfig,
    AdamWState,
    accumulate_grads,
    apply,
    clip_by_global_norm,
    global_norm,
    init,
    lr_schedule,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "accumulate_grads",
    "apply",
    "clip_by_global_norm",
    "global_norm",
    "init",
    "lr_schedule",
]
