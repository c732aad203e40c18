"""Remote victim ranking, stolen-segment transfer, donation accounting (port
of ``repro/mesh_ws/steal.py``).

The cross-device Steal is the paper's Steal lifted one level, with one twist
that keeps it fence-free: the plan is **replicated**.  Every device holds
the same exchanged advisories and the same gathered head/tail snapshots, so
every device runs the same deterministic planning sweep (a static loop over
device ids) and arrives at the *same* assignment: thief ``t`` takes the
tail half of each queue of its best-scored victim, and later thieves see
the tails earlier (lower-id) thieves already cut.  So:

* stolen segments are **disjoint** across thieves and from the victim's
  retained prefix: a clean run has at most one cross-device execution a
  tile and the normalised combine equals the no-drop oracle;
* the victim needs no message to learn what it donated: it reads its own
  cut tails out of the replicated plan and corrects its advisory locally;
* staleness stays harmless: a victim that drained past the snapshot's head
  hands over a short (possibly empty) segment, and the thief's launch finds
  ``s_head >= s_tail`` and does nothing.

Victim ranking is locality-weighted (arXiv:1804.04773): ``score(v) =
advisory(v) - alpha·hops(t, v)``, ``alpha`` in tile-slots a hop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import resolve_axis
from repro_torch.pallas_ws.queues import QueueState

from .advisory import psum

INF = 1 << 30


def hops_matrix(n_devices: int, device=None) -> torch.Tensor:
    """Ring distance between devices: ``hops[t, v]`` peer hops t → v (int32)."""
    ids = torch.arange(n_devices, dtype=torch.int32, device=device)
    fwd = (ids[None, :] - ids[:, None]) % n_devices
    bwd = (ids[:, None] - ids[None, :]) % n_devices
    return torch.minimum(fwd, bwd)


class StealPlan(NamedTuple):
    """One device's slice of the replicated plan (int32 tensors, ``stole``
    bool).  ``victim``/``stole`` describe this device *as thief*;
    ``s_head``/``s_tail`` bound its stolen segments of the victim's pool
    (empty when ``stole`` is False).  ``new_tail`` describes this device
    *as victim*: its own tails after every donation of the plan."""

    victim: torch.Tensor      # scalar: device whose segment we execute
    stole: torch.Tensor       # scalar bool: did this device steal at all
    s_head: torch.Tensor      # [El] stolen segment start (victim tile index)
    s_tail: torch.Tensor      # [El] stolen segment end
    new_tail: torch.Tensor    # [El] own tails after donation truncation
    take_tiles: torch.Tensor  # scalar: tiles this device stole


def plan_steals_all(adv, g_head, g_tail, *, n_devices: int, bt: int,
                    alpha: int = 1) -> list[StealPlan]:
    """The replicated planning sweep, every device's slice of it.  Inputs are
    post-exchange snapshots, the same on every device: ``adv [D]`` advisory
    scalars, ``g_head [D, El]`` head snapshots, ``g_tail [D, El]`` tails.

    Thieves are the advisory-idle devices; they plan in device-id order,
    each choosing the victim that maximises ``advisory - alpha·hops`` (ties
    to the first index, as ``jnp.argmax``) and taking the tail half of
    every remaining queue segment (``ceil(rem / 2)`` tiles).  Earlier
    thieves' takes update the working tails and advisories, so plans never
    overlap.  Torch ops on the inputs' device, no host read."""
    g_tail = torch.as_tensor(g_tail).to(torch.int32)
    dev = g_tail.device
    adv = torch.as_tensor(adv).to(device=dev, dtype=torch.int32)
    g_head = torch.as_tensor(g_head).to(device=dev, dtype=torch.int32)
    ids = torch.arange(n_devices, dtype=torch.int32, device=dev)
    hops = hops_matrix(n_devices, dev)
    neg = torch.full((n_devices,), -INF, dtype=torch.int32, device=dev)

    cur_tail = g_tail.clone()
    adv_cur = adv.clone()
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    plans = []
    for t in range(n_devices):
        idle_t = adv[t] == 0
        score = adv_cur - alpha * hops[t]
        score = torch.where(ids == t, neg, score)
        score = torch.where(adv_cur > 0, score, neg)
        v = torch.argmax(score)                   # first index of the max
        can_t = idle_t & (score.max() > -INF)
        rem = torch.clamp(cur_tail[v] - torch.clamp(g_head[v], min=0), min=0)
        take = torch.where(can_t, (rem + 1) // 2, 0)
        h_mid = cur_tail[v] - take
        plans.append(StealPlan(victim=torch.where(can_t, v.to(torch.int32), zero), stole=can_t,
                               s_head=torch.where(can_t, h_mid, 0),
                               s_tail=torch.where(can_t, cur_tail[v], 0), new_tail=None,
                               take_tiles=torch.where(can_t, take.sum(dtype=torch.int32), 0)))
        cur_tail[v] = torch.where(can_t, h_mid, cur_tail[v])
        adv_cur[v] = adv_cur[v] - torch.where(can_t, take.sum(dtype=torch.int32) * bt, 0)
    return [p._replace(new_tail=cur_tail[m].clone()) for m, p in enumerate(plans)]


def plan_steals(adv, g_head, g_tail, me: int, *, n_devices: int, bt: int,
                alpha: int = 1) -> StealPlan:
    """This device's slice of :func:`plan_steals_all` (``me`` is its mesh
    index, which only picks the slice returned)."""
    return plan_steals_all(adv, g_head, g_tail, n_devices=n_devices, bt=bt, alpha=alpha)[me]


def steal_pairs(plans) -> list[tuple[int, int]]:
    """``(thief, victim)`` of every device that steals in the replicated
    plan (one host read)."""
    stole = torch.stack([p.stole for p in plans]).tolist()
    victim = torch.stack([p.victim for p in plans]).tolist()
    return [(t, v) for t, (s, v) in enumerate(zip(stole, victim)) if s]


def send_stolen_shards(shard, pairs, axis):
    """The weight half of the stolen-segment transfer: each victim sends its
    expert shard (``(wg, wu, wd)``, in their own dtype) to every thief that
    the replicated plan ``pairs`` names, point to point, and each thief
    receives its victim's.  Every rank knows the plan, so nothing else is
    sent: a rank that is neither sends and receives nothing, and when no
    rank steals no weight moves.  gloo sends only CPU tensors, so a shard
    travels one tensor at a time through a host buffer.  Returns the
    victim's shard on a thief's device, ``None`` on any other rank."""
    ax = resolve_axis(axis)
    me = ax.index
    thieves = [t for t, v in pairs if v == me]
    victim = [v for t, v in pairs if t == me]
    if not thieves and not victim:
        return None
    got = []
    for tag, w in enumerate(shard):
        host = w.detach().to("cpu").contiguous() if thieves else None
        buf = torch.empty(w.shape, dtype=w.dtype) if victim else None
        reqs = [dist.isend(host, ax.global_rank(t), group=ax.group, tag=tag) for t in thieves]
        if victim:
            reqs.append(dist.irecv(buf, ax.global_rank(victim[0]), group=ax.group, tag=tag))
        for r in reqs:
            r.wait()
        if victim:
            got.append(buf.to(w.device))
    return tuple(got) if victim else None


def steal_queue_state(g_records, g_toff, plan: StealPlan, *, n_programs: int,
                      pool_tiles: int, bt: int, victim: int) -> QueueState:
    """Queue state for the thief's launch over the victim's gathered pool: a
    fresh view of the stolen segments only (shared heads at ``s_head``,
    tails at ``s_tail``; local heads and ``taken`` fresh).  Records carry
    the victim's LOCAL expert ids, so the thief feeds the victim's weight
    shard (:func:`send_stolen_shards`) directly.  A non-thief has ``s_head == s_tail == 0``:
    every probe misses and its launch does nothing.  ``victim`` is
    ``int(plan.victim)``, read once by the caller to take views of the
    gathered blocks."""
    n_local = plan.s_head.shape[0]
    dev = plan.s_head.device
    return QueueState(
        tasks=g_records[victim],
        head=plan.s_head,
        tail=plan.s_tail,
        local_head=torch.zeros((n_programs, n_local), dtype=torch.int32, device=dev),
        taken=torch.full((pool_tiles,), -1, dtype=torch.int32, device=dev),
        task_list=None,
        n_tasks_hint=pool_tiles,
        remaining=(plan.s_tail - plan.s_head) * bt,
        pool_off=g_toff[victim],
    )


def deliver_home(out_s, mult_s, plan: StealPlan, axis, *, n_devices: int, me: int):
    """Route stolen contributions back to their home device: each thief
    drops its launch output into the box row of its victim, one sum over
    the axis merges the boxes, and each device reads its own row.  Returns
    ``(out_in [n_rows, d], mult_in [pool_tiles], wrote_in [pool_tiles])``:
    the delivered rows, executions, and the number of thieves whose launch
    wrote each tile (free mode's combine divides by the writers, since a
    free launch stores whole normalised tiles).  Disjoint stolen segments
    put at most one nonzero contributor on every element, so the sum is
    exact in any order."""
    n_rows, d = out_s.shape
    pool_tiles = mult_s.shape[0]
    v = plan.victim.long()
    out_box = out_s.new_zeros((n_devices, n_rows, d))
    out_box[v] = torch.where(plan.stole, out_s, 0.0)
    int_box = torch.zeros((n_devices, 2, pool_tiles), dtype=torch.int32, device=out_s.device)
    int_box[v] = torch.where(plan.stole, torch.stack([mult_s, (mult_s > 0).to(torch.int32)]), 0)
    out_in = psum(out_box, axis)[me]
    mult_in, wrote_in = psum(int_box, axis)[me]
    return out_in, mult_in, wrote_in
