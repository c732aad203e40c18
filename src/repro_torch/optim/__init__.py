"""Optimizers and schedules of the port (``repro.optim`` counterpart, without
the int8 gradient compression of the cross-pod all-reduce)."""

from .optimizer import (
    OptState,
    Optimizer,
    clip_by_global_norm,
    global_norm,
    make_adafactor_momentum,
    make_adamw,
    tree_leaves,
    tree_map,
)
from .schedules import cosine_schedule, wsd_schedule

__all__ = [
    "OptState", "Optimizer", "clip_by_global_norm", "cosine_schedule", "global_norm",
    "make_adafactor_momentum", "make_adamw", "tree_leaves", "tree_map", "wsd_schedule",
]
