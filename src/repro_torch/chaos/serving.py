"""Fault plans for the serving layer (frontend + engine step), port of
``repro/chaos/serving.py``.

Two small, seedable descriptions consumed by
:mod:`repro_torch.serving.engine`:

* :class:`ReplicaCrashPlan` — kill replicas at chosen frontend iterations.
  The frontend collects the dead replica's in-flight requests and
  re-admits them to survivors **idempotently**: the resume request's
  prompt is the original prompt plus the tokens already emitted, its
  budget is the remaining budget, and completion reassembly splices the
  pre-crash emission back in front — so a request's final stream is
  identical to an uninterrupted run (greedy decode is deterministic) and
  no token is ever emitted twice.  The dead replica's *queue* survives the
  crash: queued-but-unadmitted work is stolen by the survivors, which is
  the paper's whole point.

* :class:`EngineFaultPlan` — per-step faults inside one
  ``ContinuousBatcher``: ``poison_steps`` corrupts the unified launch's
  logits to NaN (a wedged kernel), ``slow_steps`` inflates the observed
  step latency past the watchdog deadline.  Both trigger the unified→split
  graceful-degradation fallback rather than a crash or a wrong token.

Both plans are data-only (no engine imports) so chaos stays a leaf
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class ReplicaCrashPlan:
    """``crash_at[replica] = frontend iteration`` at which that replica's
    batcher dies (slots lost, queue surviving)."""

    crash_at: Dict[int, int] = field(default_factory=dict)

    def due(self, iteration: int):
        return [r for r, it in self.crash_at.items() if it == iteration]


@dataclass(frozen=True)
class EngineFaultPlan:
    """Per-step fault injection for one ``ContinuousBatcher``."""

    poison_steps: Tuple[int, ...] = ()   # unified logits -> NaN at these steps
    slow_steps: Tuple[int, ...] = ()     # observed latency += added_latency_s
    added_latency_s: float = 1e9

    def poisons(self, step_idx: int) -> bool:
        return step_idx in self.poison_steps

    def slows(self, step_idx: int) -> bool:
        return step_idx in self.slow_steps
