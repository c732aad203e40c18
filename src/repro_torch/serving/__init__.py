"""Serving engine of the port (``repro.serving`` counterpart)."""

from .engine import ContinuousBatcher, Request, WorkStealingFrontend

__all__ = ["ContinuousBatcher", "Request", "WorkStealingFrontend"]
