"""Structured host-side view of a traced WS launch (copy of
``repro/wstrace/trace.py``).

:class:`WSTrace` wraps the decoded event stream of one ``launch_ws_grid``
run (see :mod:`.ring` for the record schema) plus enough
launch context — program/queue counts, makespan, the initial per-queue cost
loads — to answer the scheduling questions the aggregate ``WSRunResult``
counters cannot: which program stole from whom in which round, how deep
each queue drained, and where the idle rounds went.

All analyses are plain numpy over the int32 stream.  A free-mode launch
has no rounds: its ``EV_ROUND`` is the program's own clock in tile-slots
(:mod:`.ring`), so ``utilization`` and ``idle_attribution`` read per-program
busy time, not a shared timeline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .ring import (
    EV_COST,
    EV_KIND,
    EV_OP,
    EV_PROG,
    EV_QUEUE,
    EV_ROUND,
    EV_VICTIM,
    EVENT_WIDTH,
    KIND_TAKE,
    decode_rings,
    host,
)


def _family_name(op: int) -> str:
    """Resolve an EV_OP code to its task-family name via the registry;
    falls back to the bare op code in bare (registry-less) environments."""
    try:
        from ..pallas_ws.tasks import family_of

        return family_of(int(op)).name
    except Exception:
        return f"op{int(op)}"


@dataclass
class WSTrace:
    """Decoded event stream + per-launch context of one traced WS run."""

    events: np.ndarray       # [n_events, EVENT_WIDTH], (round, program)-sorted
    n_programs: int
    n_queues: int
    makespan: int
    dropped: np.ndarray      # [n_programs] ring-overflow drops
    queue_loads: Optional[np.ndarray] = None  # initial cost per queue
    # per-device phase counters of a mesh run; None until the mesh path is
    # ported (the Perfetto export renders them when present)
    mesh_phases: Optional[List[dict]] = field(default=None)

    @classmethod
    def from_run(cls, state, res) -> "WSTrace":
        """Build from a host ``QueueState`` + traced ``WSRunResult`` pair."""
        if res.events is None:
            raise ValueError(
                "run has no event rings — launch with trace=True to record"
            )
        stream, dropped = decode_rings(res.events, res.ev_cursor)
        loads = state.remaining
        if loads is None:
            from ..pallas_ws.queues import queue_costs

            loads = queue_costs(state)
        return cls(
            events=stream,
            n_programs=int(res.events.shape[0]),
            n_queues=int(state.n_queues),
            makespan=int(res.makespan),
            dropped=np.asarray(dropped),
            queue_loads=np.array(host(loads)),
        )

    # -- basic views ------------------------------------------------------

    @property
    def n_events(self) -> int:
        return int(self.events.shape[0])

    @property
    def steal_mask(self) -> np.ndarray:
        return self.events[:, EV_KIND] != KIND_TAKE

    @property
    def n_steals(self) -> int:
        return int(self.steal_mask.sum())

    @property
    def steal_ratio(self) -> float:
        """Fraction of extractions that were cross-queue steals."""
        return self.n_steals / max(1, self.n_events)

    # -- analyses ---------------------------------------------------------

    def utilization(self) -> np.ndarray:
        """Per-round fraction of programs busy, length ``makespan``.

        Each event occupies the tile-slot interval
        ``[EV_ROUND, EV_ROUND + EV_COST)``; intervals are accumulated with a
        difference array, so the cost is O(events + makespan).
        """
        util = np.zeros(max(self.makespan, 1) + 1, np.int64)
        if self.n_events:
            t0 = self.events[:, EV_ROUND]
            t1 = np.minimum(t0 + self.events[:, EV_COST], self.makespan)
            np.add.at(util, t0, 1)
            np.add.at(util, t1, -1)
        busy = np.cumsum(util)[: max(self.makespan, 1)]
        return busy / max(self.n_programs, 1)

    def steal_locality(self) -> dict:
        """Histogram of ring distance ``min(|p - victim|, P - |p - victim|)``
        over steal events whose queue has an owner program (victim >= 0) —
        the locality metric of arXiv:1804.04773.  Unowned-queue steals
        (expert layouts with n_queues > P) are reported under ``"unowned"``.
        """
        ev = self.events[self.steal_mask]
        victims = ev[:, EV_VICTIM]
        owned = victims >= 0
        d = np.abs(ev[owned, EV_PROG] - victims[owned])
        d = np.minimum(d, self.n_programs - d)
        hist = {int(k): int(n) for k, n in zip(*np.unique(d, return_counts=True))}
        unowned = int((~owned).sum())
        if unowned:
            hist["unowned"] = unowned
        return hist

    def family_counts(self) -> dict:
        """Extractions per task family (via EV_OP) — in a unified mixed-mode
        launch this shows all families flowing through ONE ring stream."""
        out: dict = {}
        if self.n_events:
            ops, counts = np.unique(self.events[:, EV_OP], return_counts=True)
            for op, n in zip(ops, counts):
                name = _family_name(int(op))
                out[name] = out.get(name, 0) + int(n)
        return out

    def per_queue_drain(self) -> np.ndarray:
        """Claim events per queue, ``[n_queues]`` — how deep each queue was
        drained (duplicate claims of a rewound slot each count: this is
        extraction traffic, not distinct-slot coverage)."""
        drain = np.zeros(self.n_queues, np.int64)
        if self.n_events:
            np.add.at(drain, self.events[:, EV_QUEUE], 1)
        return drain

    def idle_attribution(self) -> dict:
        """Split each program's idle rounds into *tail* idle (after its last
        event ended — nothing left to claim) and *gap* idle (between events —
        probes that found nothing while work still existed elsewhere)."""
        busy = np.zeros(self.n_programs, np.int64)
        last_end = np.zeros(self.n_programs, np.int64)
        for p in range(self.n_programs):
            ev = self.events[self.events[:, EV_PROG] == p]
            busy[p] = int(ev[:, EV_COST].sum())
            if len(ev):
                last_end[p] = int((ev[:, EV_ROUND] + ev[:, EV_COST]).max())
        idle = np.maximum(self.makespan - busy, 0)
        tail = np.maximum(self.makespan - last_end, 0)
        tail = np.minimum(tail, idle)
        return {
            "idle": idle,
            "tail_idle": tail,
            "gap_idle": idle - tail,
            "total_idle": int(idle.sum()),
            "total_tail_idle": int(tail.sum()),
            "total_gap_idle": int((idle - tail).sum()),
        }

    def summary(self) -> dict:
        """Compact JSON-able digest — the trace-derived bench columns."""
        util = self.utilization()
        idle = self.idle_attribution()
        return {
            "events": self.n_events,
            "dropped": int(self.dropped.sum()),
            "steals": self.n_steals,
            "steal_ratio": round(self.steal_ratio, 4),
            "utilization_mean": round(float(util.mean()), 4),
            "families": self.family_counts(),
            "steal_locality": {str(k): v for k, v in self.steal_locality().items()},
            "tail_idle": idle["total_tail_idle"],
            "gap_idle": idle["total_gap_idle"],
        }
