"""Segmented fault injection for the port's megakernels (copy of
``repro/chaos/inject.py``).

A :class:`~repro_torch.chaos.plan.FaultPlan` names a deterministic sequence
of launch *segments*:

    [kill × len(plan.kills)]  [storm × plan.storms]  [final]

* the first segment starts from the pristine queue state with the plan's
  launch faults applied (program stalls via the initial clock vector,
  advisory corruption via ``remaining``);
* a **kill** segment runs with a deliberately under-provisioned budget —
  the launch dies mid-schedule; the next segment resumes from the
  surviving shared arrays (head / local bounds / announcements / advisory),
  exactly the state a relaunch after a preempted kernel would see;
* a **storm** segment first applies a head-rewind storm (stale ``head``
  republishes + wiped ``local_head`` rows, clamped to legally-stale values
  ≤ the current head) and then relaunches with a full budget;
* the **final** segment always runs with the full budget from a fresh
  clock, so every surviving task drains.

The budget is the launch's ``rounds``.  In lockstep (``mode="lockstep"``,
the reference's semantics) it is the round budget, the full one the
Graham bound ``rounds``.  Free mode has no rounds: a traced free launch
stops a CTA once its own clock (the tile-slots it ran, plus its stall)
reaches a positive ``rounds``, so a kill segment passes its budget and the
storm and final segments pass 0, no budget.

Each segment records its start snapshot (head, local bounds) and its
decoded trace stream; :mod:`repro_torch.chaos.checker` replays the paper's
§7 contract over those records.  Outputs and multiplicity counters are
carried across segments (``out=``/``mult=`` relaunch kwargs), so the final
``out`` is the duplicated accumulation (lockstep) or the stored tiles
(free) that the fault-free answer must be recovered from.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from ..wstrace.ring import decode_rings, host
from .plan import FaultPlan, RewindSpec, apply_rewind, resume_state


@dataclass
class Segment:
    """One launch segment plus the snapshot the checker needs."""

    kind: str                 # "initial" | "kill" | "storm" | "final"
    budget: int               # rounds provisioned for this launch (free: 0 = none)
    start_head: np.ndarray    # [n_queues] head at segment start (post-fault)
    start_local: np.ndarray   # [n_programs, n_queues] local bounds at start
    stream: np.ndarray        # decoded (round, prog)-sorted events
                              #   [n, ring.EVENT_WIDTH]
    dropped: int              # ring-overflow drops in this segment
    res: object               # the raw WSRunResult


@dataclass
class ChaosRunResult:
    plan: FaultPlan
    segments: List[Segment]
    rounds_full: int
    tails: Optional[np.ndarray] = None  # [n_queues] static queue tails

    @property
    def res(self):
        """The final segment's WSRunResult (carried out / mult / arrays)."""
        return self.segments[-1].res

    @property
    def mode(self) -> str:
        """``"lockstep"`` or ``"free"``: the final launch's walk."""
        return getattr(self.res, "mode", "lockstep")

    @property
    def mult(self) -> np.ndarray:
        return host(self.res.mult)

    @property
    def dropped(self) -> int:
        return sum(s.dropped for s in self.segments)


def _clamped(spec: RewindSpec, head: np.ndarray) -> RewindSpec:
    """Storm targets are drawn at plan time against the queue *capacity*;
    clamp them to the live head so every republish is a legally-stale
    value (a plain write can only resurface something head once held)."""
    tgts = {q: min(t, int(head[q])) for q, t in spec.head_targets.items()}
    return dataclasses.replace(spec, head_targets=tgts)


def run_with_faults(state, launch: Callable, plan: Optional[FaultPlan], *,
                    rounds: int, mode: str = "lockstep",
                    steal_run_cap: Optional[int] = None) -> ChaosRunResult:
    """Drive ``launch`` through the plan's segment sequence.

    ``launch(state, *, rounds, out, mult, fault_plan)`` must run the
    schedule with ``trace=True`` in ``mode`` and return a ``WSRunResult``
    (e.g. a one-line wrapper around ``run_moe_schedule`` /
    ``run_ws_schedule``).  ``rounds`` is the fault-free Graham budget
    (with half-run steals, the bound of that cap);
    segment 0 gets ``plan.max_stall`` extra so stalled programs still meet
    the bound.  ``state`` is a host-built ``QueueState``.  A given
    ``steal_run_cap`` is passed to every segment's launch as
    ``launch(..., steal_run_cap=cap)``, so one callable serves every cap.
    """
    if mode not in ("lockstep", "free"):
        raise ValueError(f"mode must be 'lockstep' or 'free': {mode!r}")
    plan = plan if plan is not None else FaultPlan()
    specs = plan.storm_specs(state)
    full = rounds if mode == "lockstep" else 0

    # (kind, budget, rewind-spec-or-None); the final segment always runs
    # the full budget so the schedule is guaranteed to drain
    seq = [("kill", int(k), None) for k in plan.kills]
    seq += [("storm", full, s) for s in specs]
    seq += [("final", full, None)]

    segments: List[Segment] = []
    out = mult = None
    cap = {} if steal_run_cap is None else {"steal_run_cap": steal_run_cap}
    for i, (kind, budget, spec) in enumerate(seq):
        if i > 0:
            resume_state(state, segments[-1].res)
        if spec is not None:
            apply_rewind(state, _clamped(spec, host(state.head)))
        seg_plan = plan if i == 0 else None
        if i == 0 and budget:
            budget += plan.max_stall
        start_head = np.array(host(state.head))
        start_local = np.array(host(state.local_head))
        res = launch(state, rounds=budget, out=out, mult=mult,
                     fault_plan=seg_plan, **cap)
        stream, dropped = decode_rings(res.events, res.ev_cursor)
        segments.append(Segment(kind=kind, budget=budget,
                                start_head=start_head,
                                start_local=start_local,
                                stream=stream,
                                dropped=int(np.sum(dropped)), res=res))
        out, mult = res.out, res.mult

    return ChaosRunResult(plan=plan, segments=segments, rounds_full=rounds,
                          tails=np.array(host(state.tail)))


def single_launch(state, res) -> ChaosRunResult:
    """A fault-free traced launch of ``state`` (its pre-launch arrays) as a
    one-segment run, so :class:`~repro_torch.chaos.checker.SafetyChecker`
    can hold it to the contract."""
    stream, dropped = decode_rings(res.events, res.ev_cursor)
    seg = Segment(kind="final", budget=0, start_head=np.array(host(state.head)),
                  start_local=np.array(host(state.local_head)), stream=stream,
                  dropped=int(np.sum(dropped)), res=res)
    return ChaosRunResult(plan=FaultPlan(), segments=[seg], rounds_full=0,
                          tails=np.array(host(state.tail)))
