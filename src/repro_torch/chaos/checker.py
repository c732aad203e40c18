"""Relaxed-semantics safety checker for fault-injected scheduler runs
(copy of ``repro/chaos/checker.py``, with a free-mode reading).

WS-WMULT's contract under arbitrary asynchrony (arXiv:2008.04424 §7) is
*work-stealing with multiplicity*: a task may run more than once, but

1. **no lost task** — every Put task is extracted at least once;
2. **bounded multiplicity** — a slot is re-extractable only when a stale
   ``head`` republish (a storm) or a wiped ``local_head`` (a fresh thief)
   re-arms it; within one launch a program's ``local_head`` is strictly
   increasing, so each (program, queue, slot) is claimed at most once, and
   per round no slot is claimed twice;
3. **exactness via normalization** — outputs accumulated with duplicates,
   divided by the multiplicity counters, are bit-identical to a fault-free
   run.

The checker replays those clauses over a :class:`repro_torch.chaos.inject.
ChaosRunResult`: each segment's decoded trace stream plus its start-of-
segment snapshot (head, local bounds).  The multiplicity bound is checked
in its *exact* form — claims of slot ``(q, s)`` in a segment require a
program whose effective head view at segment start was ≤ ``s``, so

    mult(q, s)  ≤  #{segments i : start_head_i[q] ≤ s < tail[q]
                                  and min_p start_local_i[p, q] ≤ s}

which specializes to the paper's "1 + concurrent thieves" phrasing: one
claim for the pristine segment plus one per storm that re-armed the slot.
All checks are numpy-only; violations carry enough detail to replay the
offending plan from its seed.

**Free mode** (the run's ``mode``, ``"free"``: P CTAs run Take/Steal
concurrently, the setting of the paper, which the reference's one-cell-at-
a-time interpret mode only models).  The clauses read:

* clause 1 (no lost task), the stream/mult balance, clause 2a (a program
  never claims one (queue, slot) twice within a launch: its ``local_head``
  row only grows) and drain hold unchanged;
* clause 2b (no slot claimed twice in one round) does not apply: free
  mode has no rounds, and concurrent thieves claiming one slot are the
  sanctioned multiplicity.  It is skipped, and ``stats`` says so;
* clause 2c keeps its arming rule with another bound: within a launch a
  program ``p`` can claim slot ``(q, s)`` only if its view at launch start
  was at or below ``s`` (a head write stores a view plus one, so head never
  drops below its start value within the launch), and at most once, so

      mult(q, s)  ≤  Σ_{segments i that armed the slot}
                         #{p : max(start_head_i[q], start_local_i[p, q]) ≤ s}

* clause 3: free mode stores whole normalised tiles, so ``out`` is
  compared with the fault-free output as it stands (``normalized`` /
  ``oracle_normalized``), bitwise where the tile math is the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..wstrace.ring import (  # noqa: F401  (EV_* re-exported for tests)
    EV_KIND, EV_PROG, EV_QUEUE, EV_ROUND, EV_SLOT, EV_TID, host,
)


@dataclass
class Violation:
    kind: str
    detail: str

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[{self.kind}] {self.detail}"


@dataclass
class ChaosReport:
    ok: bool
    violations: List[Violation]
    max_mult: int
    n_claims: int
    n_tasks: int
    dropped: int
    # "bitwise" (exact replay / exact normalization), "close" (within
    # float-normalization tolerance), "diverged", or None (not checked)
    normalized_parity: Optional[str] = None
    stats: dict = field(default_factory=dict)

    def summary(self) -> dict:
        return dict(ok=self.ok, max_mult=self.max_mult,
                    n_claims=self.n_claims, n_tasks=self.n_tasks,
                    dropped=self.dropped,
                    normalized_parity=self.normalized_parity,
                    violations=[str(v) for v in self.violations])


def _count(violations, kind: str) -> int:
    return sum(v.kind == kind for v in violations)


class SafetyChecker:
    """Verify the §7 contract over a segmented fault-injection run."""

    def check(self, chaos, *, n_tasks: int,
              normalized=None, oracle_normalized=None,
              oracle_accumulated=None, row_mult=None,
              rtol: float = 1e-6, atol: float = 1e-6) -> ChaosReport:
        """``chaos`` is a :class:`repro_torch.chaos.inject.ChaosRunResult`
        from a traced run; its ``mode`` selects the lockstep or the free-mode
        reading of the contract (module docstring).  Output parity vs the fault-free oracle comes in two
        strengths:

        * **exact replay** (``oracle_accumulated`` [rows, ...] — the
          fault-free accumulated output, every row mult 1 — plus
          ``row_mult`` [rows]): rows whose every element comes from ONE
          tile (the moe layout) accumulate the *same* float value mult
          times, so the checker replays that float addition and demands
          the faulted output **bitwise** — the "mult-normalized outputs
          bit-identical to the fault-free run" clause in its exact-
          arithmetic form;
        * **normalized closeness** (``normalized`` / ``oracle_normalized``):
          multi-source rows (attention: several k-tiles per output element,
          each duplicated independently) normalize by division, where
          float non-associativity costs ULPs — compared with
          ``rtol``/``atol`` (same bar as the repo's rewind drills)."""
        violations: List[Violation] = []
        segs = chaos.segments
        final = chaos.res
        free = getattr(chaos, "mode", "lockstep") == "free"
        mult = host(final.mult)[:n_tasks]
        dropped = chaos.dropped

        # -- clause 1: no lost task ------------------------------------
        lost = np.flatnonzero(mult < 1)
        if lost.size:
            violations.append(Violation(
                "lost-task",
                f"tasks {lost[:8].tolist()} never executed (mult==0)"))

        # -- stream / counter balance (exact when nothing overflowed) --
        claims = np.zeros((n_tasks,), np.int64)
        for seg in segs:
            if seg.stream.shape[0]:
                tids = seg.stream[:, EV_TID]
                live = (tids >= 0) & (tids < n_tasks)
                np.add.at(claims, tids[live], 1)
        if dropped == 0 and not np.array_equal(claims, mult.astype(np.int64)):
            bad = np.flatnonzero(claims != mult)
            violations.append(Violation(
                "stream-mult-mismatch",
                f"trace stream claim counts != mult for tids "
                f"{bad[:8].tolist()} (stream {claims[bad[:8]].tolist()} vs "
                f"mult {mult[bad[:8]].tolist()})"))

        # -- clause 2a: per-segment (program, queue, slot) uniqueness --
        # a program's local_head is strictly increasing within a launch,
        # so no program can re-extract a slot it already claimed
        for i, seg in enumerate(segs):
            if not seg.stream.shape[0]:
                continue
            keys = (seg.stream[:, EV_PROG], seg.stream[:, EV_QUEUE],
                    seg.stream[:, EV_SLOT])
            _, counts = np.unique(np.stack(keys, 1), axis=0,
                                  return_counts=True)
            if (counts > 1).any():
                violations.append(Violation(
                    "program-reclaim",
                    f"segment {i} ({seg.kind}): a program claimed the same "
                    f"(queue, slot) twice within one launch"))

        # -- clause 2b: per (segment, round) no slot claimed twice -----
        # (lockstep only: free mode has no rounds, and concurrent thieves
        # claiming one slot are the sanctioned multiplicity)
        for i, seg in enumerate(segs):
            if free or not seg.stream.shape[0]:
                continue
            keys = np.stack((seg.stream[:, EV_ROUND], seg.stream[:, EV_QUEUE],
                             seg.stream[:, EV_SLOT]), 1)
            _, counts = np.unique(keys, axis=0, return_counts=True)
            if (counts > 1).any():
                violations.append(Violation(
                    "round-double-claim",
                    f"segment {i} ({seg.kind}): a slot was claimed twice "
                    f"in the same round"))

        # -- clause 2c: the multiplicity bound -------------------------
        # claims of (q, s) in segment i need an effective head view ≤ s at
        # segment start: head_i[q] ≤ s and some program's local bound ≤ s.
        # Lockstep arms one claim per segment; free mode one per program
        # whose view max(head_i[q], local_i[p, q]) was ≤ s.
        if dropped == 0:
            per_slot: dict = {}
            armed: dict = {}
            for i, seg in enumerate(segs):
                h = np.asarray(seg.start_head)
                loc = np.asarray(seg.start_local)
                lo = loc.min(axis=0)  # [n_queues]
                for ev in seg.stream:
                    q, s = int(ev[EV_QUEUE]), int(ev[EV_SLOT])
                    per_slot[(q, s)] = per_slot.get((q, s), 0) + 1
                for (q, s) in per_slot:
                    if h[q] <= s and lo[q] <= s:
                        armed[(q, s, i)] = (
                            int((np.maximum(loc[:, q], h[q]) <= s).sum())
                            if free else 1)
            for (q, s), n in per_slot.items():
                bound = sum(armed.get((q, s, i), 0) for i in range(len(segs)))
                if n > bound:
                    violations.append(Violation(
                        "multiplicity-bound",
                        f"slot (q={q}, s={s}) claimed {n}× but only "
                        f"{bound} segment(s) had it armed (stale-republish "
                        f"bound exceeded)"))

        # -- drain: the final full-budget segment must finish the queue -
        head = host(final.head)
        tails = getattr(chaos, "tails", None)
        if tails is not None and (head < np.asarray(tails)).any():
            q = np.flatnonzero(head < np.asarray(tails))
            violations.append(Violation(
                "not-drained",
                f"queues {q.tolist()} still hold unextracted slots after "
                f"the final full-budget segment"))

        # -- clause 3: output parity vs the fault-free oracle ----------
        parity: Optional[str] = None
        if oracle_accumulated is not None and row_mult is not None:
            got = host(final.out)
            orc = host(oracle_accumulated)
            m = host(row_mult).astype(np.int64)
            acc = np.zeros_like(orc)
            armed_rows = m.reshape(m.shape + (1,) * (orc.ndim - m.ndim))
            for i in range(int(m.max(initial=0))):
                acc = np.where(armed_rows > i,
                               (acc + orc).astype(orc.dtype), acc)
            if np.array_equal(acc, got):
                parity = "bitwise"
            else:
                parity = "diverged"
                bad = np.flatnonzero(acc.ravel() != got.ravel())[:4]
                violations.append(Violation(
                    "normalized-parity",
                    f"faulted accumulation is not the exact float replay "
                    f"of the fault-free output × mult (first diffs at "
                    f"flat idx {bad.tolist()})"))
        elif normalized is not None and oracle_normalized is not None:
            a = host(normalized)
            b = host(oracle_normalized)
            if a.shape == b.shape and np.array_equal(a, b):
                parity = "bitwise"
            elif a.shape == b.shape and np.allclose(a, b, rtol=rtol,
                                                    atol=atol):
                parity = "close"
            else:
                parity = "diverged"
                where = (np.flatnonzero(
                    ~np.isclose(a, b, rtol=rtol, atol=atol))[:4].tolist()
                    if a.shape == b.shape else "shape mismatch")
                violations.append(Violation(
                    "normalized-parity",
                    f"mult-normalized output differs from the fault-free "
                    f"oracle (first diffs at flat idx {where})"))

        return ChaosReport(
            ok=not violations,
            violations=violations,
            max_mult=int(mult.max(initial=0)),
            n_claims=int(claims.sum()),
            n_tasks=int(n_tasks),
            dropped=int(dropped),
            normalized_parity=parity,
            stats=dict(
                mode="free" if free else "lockstep",
                segments=[dict(kind=s.kind, budget=int(s.budget),
                               events=int(s.stream.shape[0]),
                               dropped=int(s.dropped)) for s in segs],
                mult_per_task=float(mult.sum()) / max(1, n_tasks),
                # violations per clause; "skipped" where the reading does
                # not apply (free mode: 2b) or the rings overflowed
                clauses={
                    "1-lost-task": _count(violations, "lost-task"),
                    "balance": (_count(violations, "stream-mult-mismatch")
                                if dropped == 0 else "skipped"),
                    "2a-program-reclaim": _count(violations, "program-reclaim"),
                    "2b-round-double-claim": (
                        "skipped" if free
                        else _count(violations, "round-double-claim")),
                    "2c-multiplicity-bound": (
                        _count(violations, "multiplicity-bound")
                        if dropped == 0 else "skipped"),
                    "drain": _count(violations, "not-drained"),
                    "3-normalized-parity": (
                        _count(violations, "normalized-parity")
                        if parity is not None else "skipped"),
                },
            ),
        )
