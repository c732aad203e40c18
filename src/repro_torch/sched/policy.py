"""Scheduler policy: Take/Steal picks over per-worker head views (port of
``repro/sched/policy.py``).

State layout (int32 tensors, on the device of the caller's inputs):

* ``tails[n_q]``  — per-queue tail (number of tasks the owner Put).  Queue q
  owns the global task range [bases[q], bases[q] + tails[q]) with
  ``bases = cumsum(tails) - tails``.  Puts are the owner's local action at
  step assembly; during the rounds tails are constant.
* ``view[n_q]``   — ONE worker's local lower bounds on every queue's head:
  the paper's RangeMaxRegister state.  The true head is ``max_w view_w[q]``.

Every pick function takes one worker's ``view [n_q]`` with a scalar
``worker_id``, or all workers' views ``[n_w, n_q]`` with ``worker_id [n_w]``
(each row picked independently, as the reference's ``jax.vmap``).

* ``pick_tasks``  — Take from the own queue if non-empty in the view, else
  Steal the head of a victim queue: 'richest' (most remaining in the view,
  tie → lower qid: ``torch.argmax`` takes the first maximum, as
  ``jnp.argmax`` does) or 'random' (a salted hash over eligible victims).
* ``pick_ranked`` — the exact mode over a synced view: stealers ranked by id
  take distinct depth-major slots across victim queues.

The hash is the reference's uint32 xorshift-multiply computed in int64 with
every product split into 16-bit halves and masked to 32 bits, so the CPU and
CUDA give the reference's bits without uint32 tensor arithmetic.  The
``axis_name`` forms (``pmax``/``pmin`` collectives inside ``shard_map``)
belong to the mesh port and raise.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MESH = "the axis_name (collective) form belongs to the mesh port (ROADMAP queue 1 item 6)"


def queue_bases(tails: torch.Tensor) -> torch.Tensor:
    """Global task-index base of each queue."""
    return torch.cumsum(tails, -1, dtype=tails.dtype) - tails


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32): the product in two
    16-bit halves of ``c``, so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash(x) -> torch.Tensor:
    """The reference's uint32 mixing (xorshift-multiply), as int64 values in
    [0, 2**32)."""
    x = torch.as_tensor(x).to(torch.int64) & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _salted_scores(n_q: int, worker_id: torch.Tensor, salt, device) -> torch.Tensor:
    """Per-queue victim scores of each worker, ``[..., n_q]`` int64 in
    [0, 2**31): the reference's ``hash(qid + hash(wid * 2654435761) + salt *
    40503)`` taken to int32 and masked with 0x7FFFFFFF."""
    qids = torch.arange(n_q, dtype=torch.int64, device=device)
    wid = worker_id.to(torch.int64) & _M32
    s = torch.as_tensor(salt, device=device).to(torch.int64) & _M32
    mix = _hash(_mul32(wid, 2654435761))[..., None]
    return _hash((qids + mix + _mul32(s, 40503)) & _M32) & 0x7FFFFFFF


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` row by row (``idx`` has x's leading shape)."""
    return x.gather(-1, idx.to(torch.int64)[..., None])[..., 0]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    q = torch.arange(n, dtype=torch.int64, device=idx.device)
    return (q == idx.to(torch.int64)[..., None]).to(torch.int32)


def _rows(view: torch.Tensor, worker_id):
    """(views [n_w, n_q], worker ids [n_w], whether the caller gave one row)."""
    wid = torch.as_tensor(worker_id, dtype=torch.int32, device=view.device)
    if view.dim() == 1:
        return view[None], wid.reshape(1), True
    return view, wid, False


def _out(single: bool, *xs):
    return tuple(x[0] for x in xs) if single else xs


def pick_tasks(view: torch.Tensor, tails: torch.Tensor, worker_id, salt=0,
               victim_policy: str = "richest"):
    """One worker's Take-else-Steal pick (head extraction only).

    Returns (task, queue, new_view) as int32: ``task`` the global task index
    or -1; ``queue`` the queue it came from (or -1); ``new_view`` the view
    with that queue's local head advanced (the paper's ``head <- head+1``).
    """
    view, wid, single = _rows(view, worker_id)
    n_q = tails.shape[0]
    remaining = torch.clamp(tails - view, min=0)
    bases = queue_bases(tails)
    have_own = _at(remaining, wid) > 0

    qids = torch.arange(n_q, dtype=torch.int64, device=view.device)
    eligible = (qids != wid.to(torch.int64)[:, None]) & (remaining > 0)
    if victim_policy == "random":
        score = _salted_scores(n_q, wid, salt, view.device)
    else:
        score = remaining.to(torch.int64)
    score = torch.where(eligible, score, torch.full_like(score, -1))
    victim = torch.argmax(score, dim=-1)
    if victim_policy == "richest":
        can_steal = _at(score, victim) > 0
    else:
        can_steal = _at(eligible, victim)

    minus1 = torch.full_like(wid, -1)
    queue = torch.where(have_own, wid, torch.where(can_steal, victim.to(torch.int32), minus1))
    got = queue >= 0
    safe_q = torch.clamp(queue, min=0)
    task = torch.where(got, _at(bases.expand_as(view), safe_q) + _at(view, safe_q), minus1)
    new_view = torch.where(got[:, None], view + _one_hot(safe_q, n_q), view)
    return _out(single, task, queue, new_view)


def pick_ranked(view: torch.Tensor, tails: torch.Tensor, worker_id, n_workers: int):
    """Deterministic collision-free pick from a *synced* view.

    Own-queue owners take their head.  Stealers (workers whose own queue is
    empty in the shared view) are ranked by id; the steal slots are the
    non-head remainder of every non-empty queue, enumerated depth-major (all
    depth-1 slots by qid, then depth-2, ...), and stealer #r takes slot #r.
    Returns (task, new_view) as int32.
    """
    view, wid, single = _rows(view, worker_id)
    n_q = tails.shape[0]
    dev = view.device
    remaining = torch.clamp(tails - view, min=0).to(torch.int64)
    bases = queue_bases(tails).expand_as(view)
    have_own = _at(remaining, wid) > 0
    own_task = _at(bases, wid) + _at(view, wid)

    # my rank among stealers (workers are queue owners: n_workers == n_q)
    is_stealer = remaining[:, :n_workers] == 0
    rank = _at(torch.cumsum(is_stealer.to(torch.int64), -1), wid) - 1

    # steal slots per queue: everything behind the head (the owner takes it)
    steal_cnt = torch.clamp(remaining - 1, min=0)
    depths = torch.arange(n_workers, dtype=torch.int64, device=dev)[:, None]
    level_cnt = (steal_cnt[:, None, :] > depths).sum(-1)        # [n_w, n_workers]
    cum = torch.cumsum(level_cnt, -1) - level_cnt                # slots before level d
    total_slots = level_cnt.sum(-1)

    # my slot: level d* = last level with cum <= rank; position p within it
    d_star = torch.clamp(((cum <= rank[:, None]) & (level_cnt > 0)).sum(-1) - 1, min=0)
    p = rank - _at(cum, d_star)
    in_level = steal_cnt > d_star[:, None]
    pos_in_level = torch.cumsum(in_level.to(torch.int64), -1) - 1
    q_star = torch.argmax((in_level & (pos_in_level == p[:, None])).to(torch.int32), dim=-1)

    can_steal = (~have_own) & (rank >= 0) & (rank < total_slots)
    offset = _at(view, q_star).to(torch.int64) + 1 + d_star
    steal_task = _at(bases, q_star).to(torch.int64) + offset

    minus1 = torch.full_like(own_task, -1)
    task = torch.where(have_own, own_task,
                       torch.where(can_steal, steal_task.to(torch.int32), minus1))
    # owner head+1; a stealer knows [head, offset] all extract this round, so
    # it may advance to offset+1 — sound ONLY because the view is synced
    hit = _one_hot(q_star, n_q).bool()
    stolen = torch.where(hit, (offset + 1).to(torch.int32)[:, None], view)
    new_view = torch.where(have_own[:, None], view + _one_hot(wid, n_q),
                           torch.where(can_steal[:, None], stolen, view))
    return _out(single, task, new_view)


def sync_views(views: torch.Tensor, axis_name: str | None = None) -> torch.Tensor:
    """MaxRegister read: the true head is the max over workers' local views
    (the ``[n_w, n_q]`` matrix form; every row gets the column max)."""
    if axis_name is not None:
        raise NotImplementedError(f"sync_views: {_MESH}")
    return views.amax(0, keepdim=True).expand_as(views).clone()


def resolve_claims(tasks: torch.Tensor, worker_ids: torch.Tensor, n_tasks: int,
                   axis_name: str | None = None) -> torch.Tensor:
    """B-WS-style claim resolution: at most one worker wins each task.

    The paper's Swap becomes a deterministic min-reduce: every worker writes
    its id into its picked task's slot and the lowest id wins.  ``tasks``
    and ``worker_ids`` are ``[n_w]``; returns a bool per worker.
    """
    if axis_name is not None:
        raise NotImplementedError(f"resolve_claims: {_MESH}")
    big = 2 ** 30
    claim = torch.full((n_tasks,), big, dtype=torch.int32, device=tasks.device)
    safe_t = torch.clamp(tasks, min=0).to(torch.int64)
    mine = torch.where(tasks >= 0, worker_ids.to(torch.int32), torch.full_like(tasks, big))
    claim.scatter_reduce_(0, safe_t, mine.to(torch.int32), reduce="amin", include_self=True)
    return (tasks >= 0) & (claim[safe_t] == worker_ids)
