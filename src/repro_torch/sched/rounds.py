"""Lockstep round driver: Take/Steal rounds for all workers under a mode
(port of ``repro/sched/rounds.py``).

One *round* = every worker extracts at most one microbatch task; rounds
proceed in lockstep.  The views matrix ``[n_workers, n_queues]`` carries
every worker's RangeMaxRegister state (``views[w, q]`` is worker w's local
lower bound on queue q's head).  The paper's shared register maps to the
*board*: the max of the views, consumed one round later (an asynchronous
publication that never blocks a round), so a worker never re-extracts a
task it extracted (weak multiplicity) while cross-worker staleness can
duplicate work, boundedly and countedly.

Modes:

* static         — no stealing: a worker only drains its own queue.
* ws-mult        — views unified every round and same-head contention
                   arbitrated by a claim min-reduce (the B-WS Swap analogue);
                   zero duplicates, a blocking exchange per round.
* ws-mult-ranked — the synced view lets every stealer take a distinct steal
                   slot (``pick_ranked``): no claims, no idle-by-collision.
* ws-wmult       — picks on local views merged with the stale board
                   (refreshed every ``sync_every`` rounds); salted random
                   victims; duplicates possible but counted.
* ws-wmult-deque — owners drain from the head, thieves steal from the tail
                   behind a per-queue reverse watermark (min-merged board);
                   staleness only duplicates the crossover region.

The reference's ``jax.lax.scan`` is a Python loop over rounds here, and its
``jax.vmap`` over workers one batched pick on the ``[n_w, n_q]`` views; the
schedule stays on the device of ``tails`` (no host read inside it).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .policy import _salted_scores, pick_ranked, pick_tasks, queue_bases, resolve_claims, sync_views

MODES = ("static", "ws-mult", "ws-mult-ranked", "ws-wmult", "ws-wmult-deque")


@dataclass
class RoundStats:
    rounds_used: int
    total_picks: int
    duplicate_picks: int
    idle_worker_rounds: int
    blocking_collectives: int
    async_collectives: int

    @property
    def duplicate_ratio(self) -> float:
        return self.duplicate_picks / max(self.total_picks, 1)


def _count(counts: torch.Tensor, eff: torch.Tensor, done_round: torch.Tensor, r: int):
    """Add a round's extractions to ``counts`` (repeated indices add up) and
    set ``done_round`` to r + 1 the first round every task is covered."""
    counts.index_add_(0, torch.clamp(eff, min=0).to(torch.int64), (eff >= 0).to(torch.int32))
    first = (done_round < 0) & (counts > 0).all()
    return torch.where(first, torch.full_like(done_round, r + 1), done_round)


def schedule_rounds(tails: torch.Tensor, n_workers: int, mode: str, sync_every: int,
                    max_rounds: int, n_tasks: int):
    """The schedule shared by the driver and the train step, on ``tails``'
    device.

    Returns (assignment [R, n_w] int32 task-or--1, counts [n_tasks] int32,
    done_round int32 0-d: first round after which every task was extracted,
    or -1).
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    tails = torch.as_tensor(tails, dtype=torch.int32)
    if mode == "ws-wmult-deque":
        return _schedule_deque(tails, n_workers, sync_every, max_rounds, n_tasks)
    dev = tails.device
    n_q = tails.shape[0]
    wids = torch.arange(n_workers, dtype=torch.int32, device=dev)
    bases = queue_bases(tails)
    views = torch.zeros((n_workers, n_q), dtype=torch.int32, device=dev)
    board = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    counts = torch.zeros((n_tasks,), dtype=torch.int32, device=dev)
    done_round = torch.tensor(-1, dtype=torch.int32, device=dev)
    assignment = torch.empty((max_rounds, n_workers), dtype=torch.int32, device=dev)
    own_hot = (torch.arange(n_q, device=dev) == wids[:, None].to(torch.int64)).to(torch.int32)
    for r in range(max_rounds):
        if mode == "ws-wmult":
            # RMaxRead: merge the stale async board into the local view
            views = torch.maximum(views, board[None, :])
        if mode == "static":
            own = views.gather(1, wids[:, None].to(torch.int64))[:, 0]
            have = tails[wids.to(torch.int64)] - own > 0
            tasks = torch.where(have, bases[wids.to(torch.int64)] + own, torch.full_like(own, -1))
            new_views = torch.where(have[:, None], views + own_hot, views)
        elif mode == "ws-mult-ranked":
            tasks, new_views = pick_ranked(views, tails, wids, n_workers)
        else:
            tasks, _q, new_views = pick_tasks(views, tails, wids, salt=r, victim_policy="random")

        if mode == "ws-mult":
            won = resolve_claims(tasks, wids, n_tasks)
            eff = torch.where(won, tasks, torch.full_like(tasks, -1))
            new_views = sync_views(new_views)  # blocking MaxRegister publish
        elif mode == "ws-mult-ranked":
            eff = tasks
            new_views = sync_views(new_views)
        else:
            eff = tasks
            if mode == "ws-wmult" and r % max(sync_every, 1) == 0:
                board = new_views.amax(0)
        views = new_views
        done_round = _count(counts, eff, done_round, r)
        assignment[r] = eff
    return assignment, counts, done_round


def _schedule_deque(tails, n_workers, sync_every, max_rounds, n_tasks):
    """ws-wmult-deque: per-worker ``heads[w, q]`` (forward frontier view,
    max-merged board) and ``rwms[w, q]`` (reverse watermark view, min-merged
    board).  A worker believes queue q has slots while
    ``heads[w, q] < rwms[w, q]``."""
    dev = tails.device
    n_q = tails.shape[0]
    wids = torch.arange(n_workers, dtype=torch.int32, device=dev)
    wid64 = wids.to(torch.int64)
    bases = queue_bases(tails)
    qids = torch.arange(n_q, dtype=torch.int64, device=dev)
    own_hot = (qids == wid64[:, None]).to(torch.int32)
    heads = torch.zeros((n_workers, n_q), dtype=torch.int32, device=dev)
    rwms = tails[None, :].expand(n_workers, n_q).clone()
    b_head, b_rwm = heads[0].clone(), rwms[0].clone()
    counts = torch.zeros((n_tasks,), dtype=torch.int32, device=dev)
    done_round = torch.tensor(-1, dtype=torch.int32, device=dev)
    assignment = torch.empty((max_rounds, n_workers), dtype=torch.int32, device=dev)
    for r in range(max_rounds):
        # RMaxRead / reverse: merge the stale async boards
        heads = torch.maximum(heads, b_head[None, :])
        rwms = torch.minimum(rwms, b_rwm[None, :])

        remaining = torch.clamp(rwms - heads, min=0)
        have_own = remaining.gather(1, wid64[:, None])[:, 0] > 0
        own_task = bases[wid64] + heads.gather(1, wid64[:, None])[:, 0]
        eligible = (qids != wid64[:, None]) & (remaining > 0)
        score = _salted_scores(n_q, wids, r, dev)
        score = torch.where(eligible, score, torch.full_like(score, -1))
        victim = torch.argmax(score, dim=-1)
        can_steal = eligible.gather(1, victim[:, None])[:, 0]
        steal_task = bases[victim] + rwms.gather(1, victim[:, None])[:, 0] - 1
        tasks = torch.where(have_own, own_task,
                            torch.where(can_steal, steal_task, torch.full_like(own_task, -1)))
        new_heads = torch.where(have_own[:, None], heads + own_hot, heads)
        vic_hot = (qids == victim[:, None]).to(torch.int32)
        new_rwms = torch.where(have_own[:, None], rwms,
                               torch.where(can_steal[:, None], rwms - vic_hot, rwms))

        if r % max(sync_every, 1) == 0:
            b_head = new_heads.amax(0)
            b_rwm = new_rwms.amin(0)
        heads, rwms = new_heads, new_rwms
        done_round = _count(counts, tasks, done_round, r)
        assignment[r] = tasks
    return assignment, counts, done_round


def run_lockstep_rounds(tails, n_workers: int, mode: str = "ws-wmult", sync_every: int = 1,
                        max_rounds: int | None = None):
    """Run the scheduler; returns (assignment [R, n_w], counts, RoundStats)
    with the arrays on the CPU.

    ``counts[t]`` is how many workers extracted task t; the done-condition is
    every task extracted at least once (the paper's at-least-once guarantee).
    ``tails`` may be a tensor on any device (the schedule runs there) or a
    sequence (the CPU).
    """
    tails = torch.as_tensor(tails, dtype=torch.int32)
    n_tasks = int(tails.sum())
    if max_rounds is None:
        max_rounds = int(tails.max()) if mode == "static" else n_tasks
        max_rounds = max(max_rounds, 1)
    assignment, counts, done_round = schedule_rounds(tails, n_workers, mode, sync_every,
                                                     max_rounds, n_tasks)
    assignment, counts, done = assignment.cpu(), counts.cpu(), int(done_round)
    rounds_used = done if done >= 0 else max_rounds
    total_picks = int((assignment[:rounds_used] >= 0).sum())
    dup = int(total_picks - (counts > 0).sum())
    idle = int(rounds_used * n_workers - total_picks)
    blocking = rounds_used if mode in ("ws-mult", "ws-mult-ranked") else 0
    async_c = 0
    if mode in ("ws-wmult", "ws-wmult-deque"):
        async_c = max(1, rounds_used // max(sync_every, 1))
    stats = RoundStats(rounds_used=rounds_used, total_picks=total_picks, duplicate_picks=dup,
                       idle_worker_rounds=idle, blocking_collectives=blocking,
                       async_collectives=async_c)
    return assignment[:rounds_used], counts, stats
