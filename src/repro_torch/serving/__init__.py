"""Serving engine of the port (``repro.serving`` counterpart)."""

from .engine import (
    CapturedWSStep,
    ContinuousBatcher,
    Request,
    WorkStealingFrontend,
    jit_decode_step_ws,
    ragged_slot_attention,
)

__all__ = ["CapturedWSStep", "ContinuousBatcher", "Request", "WorkStealingFrontend",
           "jit_decode_step_ws", "ragged_slot_attention"]
