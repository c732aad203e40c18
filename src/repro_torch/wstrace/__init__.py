"""Scheduler telemetry of the port (``repro.wstrace`` counterpart)."""

from .metrics import SchedulerMetrics

__all__ = ["SchedulerMetrics"]
