"""Asynchronous cluster simulator for the scheduler modes (makespan model);
the port's own copy of ``repro/sched/simulator.py`` (numpy only).

The lockstep driver (rounds.py) is what actually runs under SPMD; this module
models the *asynchronous* regime the paper targets (host-driven dispatch,
GPU-style clusters, or TPU pods with per-host runahead): workers finish tasks
at different times and immediately pick the next one.  It quantifies the
trade the paper measures in §8:

* static    — no stealing: stragglers own their whole queue.
* ws-mult   — every pick consults the true global state, paying
              ``sync_cost`` seconds per pick (the blocking-collective /
              MaxRegister price).  No duplicates.
* ws-wmult  — every pick is free and uses a snapshot of global state that
              refreshes only every ``refresh_period`` seconds (the async
              board).  Stale snapshots can duplicate work — each worker still
              never repeats a task it did itself (local view max).
* b-ws-wmult— like ws-wmult but claims are arbitrated (Swap analogue): a
              duplicate *pick* costs a failed-claim retry of ``claim_cost``
              instead of a full duplicate execution.

Event-driven, deterministic given the seed.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass
class SimResult:
    makespan: float
    ideal: float  # total work / total speed (perfect balance, zero overhead)
    duplicates: int
    picks: int
    sync_time: float  # total seconds spent in blocking syncs

    @property
    def efficiency(self) -> float:
        return self.ideal / self.makespan if self.makespan > 0 else 0.0


def async_makespan(
    durations: np.ndarray,  # [n_tasks] seconds of work per task
    owner_of: np.ndarray,  # [n_tasks] owning worker/queue id
    n_workers: int,
    mode: str = "ws-wmult",
    worker_speed: np.ndarray | None = None,
    sync_cost: float = 5e-6,
    claim_cost: float = 1e-6,
    refresh_period: float = 1e-4,
    seed: int = 0,
) -> SimResult:
    rng = np.random.default_rng(seed)
    n_tasks = len(durations)
    speed = worker_speed if worker_speed is not None else np.ones(n_workers)
    # FIFO queues per owner
    queues = [list(np.flatnonzero(owner_of == w)) for w in range(n_workers)]
    heads_true = np.zeros(n_workers, dtype=np.int64)  # truly extracted prefix
    # per-worker local views of every queue head (weak multiplicity state)
    views = np.zeros((n_workers, n_workers), dtype=np.int64)
    board = np.zeros(n_workers, dtype=np.int64)
    board_time = 0.0
    done = np.zeros(n_tasks, dtype=bool)
    counts = np.zeros(n_tasks, dtype=np.int64)
    sync_time_total = 0.0
    picks = 0

    def snapshot(now):
        nonlocal board, board_time
        if mode == "ws-wmult" or mode == "b-ws-wmult":
            if now - board_time >= refresh_period:
                board[:] = views.max(axis=0)
                board_time = now
            return board
        return views.max(axis=0)  # fresh truth

    def pick(w, now):
        """Return (task, overhead_seconds) or (None, overhead)."""
        nonlocal picks, sync_time_total
        overhead = 0.0
        if mode == "ws-mult":
            overhead += sync_cost
            sync_time_total += sync_cost
            views[w] = np.maximum(views[w], views.max(axis=0))
        elif mode in ("ws-wmult", "b-ws-wmult"):
            views[w] = np.maximum(views[w], snapshot(now))
        # own queue first, else richest victim (by my view)
        order = [w] + [q for q in range(n_workers) if q != w]
        remaining = np.array([len(queues[q]) - views[w][q] for q in range(n_workers)])
        if mode == "static":
            cands = [w] if remaining[w] > 0 else []
        else:
            cands = [w] if remaining[w] > 0 else (
                [int(np.argmax(np.where(np.arange(n_workers) != w, remaining, -1)))]
                if remaining.max(initial=0) > 0
                else []
            )
        for q in cands:
            if len(queues[q]) - views[w][q] <= 0:
                continue
            t = queues[q][views[w][q]]
            views[w][q] += 1
            picks += 1
            if mode == "ws-mult":
                # fresh truth + per-pick arbitration: exact, no duplicates
                if done[t]:
                    continue
                return t, overhead
            if mode == "b-ws-wmult" and done[t]:
                # Swap claim fails: pay retry, skip the stale task
                overhead += claim_cost
                continue
            return t, overhead
        return None, overhead

    # event loop: (time, worker)
    events = [(0.0, w) for w in range(n_workers)]
    heapq.heapify(events)
    finish = 0.0
    idle_until = {}
    POLL = refresh_period if refresh_period > 0 else 1e-4
    while events:
        now, w = heapq.heappop(events)
        if done.all():
            break
        t, overhead = pick(w, now)
        if t is None:
            # idle: poll again shortly (models backoff)
            if not done.all():
                heapq.heappush(events, (now + POLL, w))
            continue
        dur = durations[t] / speed[w] + overhead
        counts[t] += 1
        done[t] = True
        finish = max(finish, now + dur)
        heapq.heappush(events, (now + dur, w))

    duplicates = int(counts.sum() - (counts > 0).sum())
    ideal = float(durations.sum() / speed.sum())
    return SimResult(
        makespan=finish,
        ideal=ideal,
        duplicates=duplicates,
        picks=picks,
        sync_time=sync_time_total,
    )
