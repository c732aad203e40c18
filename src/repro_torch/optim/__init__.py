"""Optimizers, schedules and int8 error-feedback gradient compression of the
port (``repro.optim`` counterpart)."""

from .compress import int8_compress_decompress, make_ef_compressor
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
    "int8_compress_decompress", "make_adafactor_momentum", "make_adamw", "make_ef_compressor",
    "tree_leaves", "tree_map", "wsd_schedule",
]
