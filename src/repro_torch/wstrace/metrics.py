"""Serving-side scheduler metrics sink (copy of ``repro/wstrace/metrics.py``).

``ContinuousBatcher`` records one sample per engine step (wall latency +
live-slot occupancy) and one event per admission / completion;
:meth:`SchedulerMetrics.snapshot` reduces them to per-step latency
percentiles, slot utilisation and admission/completion totals.
"""

from __future__ import annotations

import numpy as np


class SchedulerMetrics:
    """Accumulates per-step serving telemetry; reduce with :meth:`snapshot`."""

    def __init__(self, slots: int | None = None):
        self.slots = slots
        self.step_latency_s: list[float] = []
        self.step_live: list[int] = []
        self.admitted = 0
        self.completed = 0
        # unified steps redone on the split path, by kind ("non-finite")
        self.degradations: dict[str, int] = {}

    def record_step(self, latency_s: float, n_live: int) -> None:
        self.step_latency_s.append(float(latency_s))
        self.step_live.append(int(n_live))

    def record_admission(self, n: int = 1) -> None:
        self.admitted += n

    def record_completion(self, n: int = 1) -> None:
        self.completed += n

    def record_degradation(self, kind: str) -> None:
        self.degradations[kind] = self.degradations.get(kind, 0) + 1

    def snapshot(self) -> dict:
        lat = np.asarray(self.step_latency_s, np.float64) * 1e3
        live = np.asarray(self.step_live, np.float64)
        out = {
            "steps": int(lat.size),
            "admitted": self.admitted,
            "completed": self.completed,
            "latency_ms": None,
            "slot_utilization": None,
            "live_mean": float(live.mean()) if live.size else 0.0,
            "degradations": dict(self.degradations),
        }
        if lat.size:
            out["latency_ms"] = {
                "p50": float(np.percentile(lat, 50)),
                "p99": float(np.percentile(lat, 99)),
                "mean": float(lat.mean()),
                "max": float(lat.max()),
            }
        if live.size and self.slots:
            out["slot_utilization"] = float(live.mean() / self.slots)
        return out
