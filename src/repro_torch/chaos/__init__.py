"""Deterministic fault injection and relaxed-semantics safety checking for
the port's fence-free megakernels (port of ``repro.chaos``, scheduler layer).

:class:`FaultPlan` (seeded stalls / advisory corruption / head-rewind
storms / kill-and-relaunch) is driven through launch segments by
:func:`run_with_faults`, and :class:`SafetyChecker` verifies the paper's §7
contract (no lost task, bounded multiplicity, normalized parity) over the
trace rings, in lockstep as the reference does and in free mode under the
reading its docstring states.  The serving layer's plans
(:class:`ReplicaCrashPlan`, :class:`EngineFaultPlan`) drive the serving
engine's crash handling and watchdog.
"""

from .checker import ChaosReport, SafetyChecker, Violation
from .inject import ChaosRunResult, Segment, run_with_faults, single_launch
from .plan import (
    ADVISORY_MODES,
    FaultPlan,
    RewindSpec,
    apply_rewind,
    corrupt_advisory,
    resume_state,
    seed_advisory,
)
from .serving import EngineFaultPlan, ReplicaCrashPlan

__all__ = [
    "ADVISORY_MODES",
    "ChaosReport",
    "ChaosRunResult",
    "EngineFaultPlan",
    "FaultPlan",
    "ReplicaCrashPlan",
    "RewindSpec",
    "SafetyChecker",
    "Segment",
    "Violation",
    "apply_rewind",
    "corrupt_advisory",
    "resume_state",
    "run_with_faults",
    "seed_advisory",
    "single_launch",
]
