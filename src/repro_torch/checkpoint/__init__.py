"""Atomic, resumable checkpoints of the port (``repro.checkpoint`` counterpart)."""

from .checkpoint import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
