"""Router output → expert-tile task queues, the host Put (port of the host
half of ``repro/moe_ws/dispatch.py``).

Routing is lowered to the paper's scheduling problem:

1.  the routed (token, expert) pairs are grouped by expert into one flat
    array (:class:`RoutedSet`); each expert owns a contiguous row range,
    padded to a multiple of the tile height ``bt``, so an expert tile owns a
    disjoint contiguous slice of the routed output;
2.  one :class:`~repro_torch.pallas_ws.tasks.ExpertTask` per tile, with
    ``cost = live rows``;
3.  the tasks go to per-expert owner queues (``partition="owner"``): a hot
    expert's queue is as overloaded as its router load, which is the skew
    the megakernel's thieves erase.

No capacity anywhere: every routed pair gets a row and every row a task,
so the dispatch is dropless.  Duplicated tile execution is normalised by
:func:`row_divisor`.  Three Puts: the host Put :func:`route_to_tasks` (task
objects, compact per-expert queues); the shared-pool Put
:func:`route_to_tasks_pool_torch` (flat records, one pool segment per
expert), the reference's traced ``route_to_tasks_pool_jax`` as torch ops on
the routing's device with no host sync, the plain version of the Put that
the unified step's post-attention glue runs in-kernel
(:func:`route_to_tasks_pool` runs it on the host for the training path and
the backward, whose queues are built there); and the padded device Put
:func:`route_to_tasks_torch` (the reference's ``route_to_tasks_jax``: every
expert at the static worst case, live masks) with
:func:`expert_queue_candidates`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.pallas_ws.kernel import STATIC_COMPRESSED_ROUNDS
from repro_torch.pallas_ws.queues import owner_queue_candidates
from repro_torch.pallas_ws.tasks import BOTTOM, OP_EXPERT_TILE, ExpertTask


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class RoutedSet:
    """Expert-grouped routed (token, expert) pairs, kernel-ready (numpy).

    Each expert's row range is padded up to a multiple of ``bt``, so every
    tile's ``[row_start, row_start + bt)`` slice is disjoint from every other
    tile's.  Pad rows point at token 0 with gate 0 and are masked dead inside
    the kernel, so they contribute exactly zero to the combine.
    """

    tok_idx: np.ndarray     # [n_rows] int32: token index per row (0 on pads)
    gates: np.ndarray       # [n_rows] float32: combine weight (0 on pads)
    expert_off: np.ndarray  # [E + 1] int32: expert e owns rows [off[e], off[e+1])
    loads: np.ndarray       # [E] int64: live routed rows per expert
    n_rows: int             # bt-aligned total rows (>= n_routed)
    n_routed: int           # live rows (== T * top_k)
    n_tokens: int
    # [n_rows] int32: the flat (token·k + choice) pair that produced each
    # row, ``n_routed`` on pads
    row_src: Optional[np.ndarray] = None

    @property
    def n_experts(self) -> int:
        return len(self.expert_off) - 1

    def expert_loads(self) -> np.ndarray:
        """Live routed rows per expert: the raw router skew."""
        return self.loads


def route_to_tasks(idx, gates, n_experts: int, bt: int = 8
                   ) -> Tuple[List[ExpertTask], RoutedSet]:
    """Lower concrete top-k routing to expert tiles.

    ``idx``: [T, k] int expert choices; ``gates``: [T, k] float combine
    weights (already normalised).  Grouping is stable in (token, choice)
    order within each expert, so the layout is deterministic.
    """
    idx = np.asarray(idx)
    gates = np.asarray(gates, dtype=np.float32)
    T, k = idx.shape
    if gates.shape != (T, k):
        raise ValueError(f"gates {gates.shape} do not match idx {(T, k)}")

    flat_e = idx.reshape(-1)
    flat_t = np.repeat(np.arange(T, dtype=np.int32), k)
    flat_g = gates.reshape(-1)
    # stable counting sort by expert: contiguous per-expert row ranges
    order = np.argsort(flat_e, kind="stable")
    loads = np.bincount(flat_e, minlength=n_experts).astype(np.int64)
    padded = -(-loads // bt) * bt  # bt-aligned range per expert
    expert_off = np.zeros(n_experts + 1, dtype=np.int32)
    np.cumsum(padded, out=expert_off[1:])
    n_rows = max(bt, int(expert_off[-1]))

    tok_idx = np.zeros(n_rows, dtype=np.int32)
    gate_rows = np.zeros(n_rows, dtype=np.float32)
    row_src = np.full(n_rows, T * k, dtype=np.int32)
    src = 0
    for e in range(n_experts):
        lo = int(expert_off[e])
        ln = int(loads[e])
        tok_idx[lo: lo + ln] = flat_t[order[src: src + ln]]
        gate_rows[lo: lo + ln] = flat_g[order[src: src + ln]]
        row_src[lo: lo + ln] = order[src: src + ln]
        src += ln

    tasks: List[ExpertTask] = []
    tid = 0
    for e in range(n_experts):
        start = int(expert_off[e])
        for i in range(0, int(loads[e]), bt):
            rl = min(bt, int(loads[e]) - i)
            tasks.append(ExpertTask(expert=e, row_start=start + i, row_len=rl,
                                    tid=tid, cost=rl))
            tid += 1

    return tasks, RoutedSet(
        tok_idx=tok_idx, gates=gate_rows, expert_off=expert_off, loads=loads,
        n_rows=n_rows, n_routed=T * k, n_tokens=T, row_src=row_src,
    )


def _group_by_expert_torch(idx, gates, n_experts: int):
    """Stable sort of the routed (token, choice) pairs by expert (the
    reference's ``_group_by_expert_jax``), as torch ops on ``idx``'s device:
    expert ``e``'s pairs are ``order[start[e] : start[e] + loads[e]]``, the
    segment bounds read off the sorted keys with ``searchsorted``."""
    idx = torch.as_tensor(idx).to(torch.int32)
    dev = idx.device
    gates = torch.as_tensor(gates).to(device=dev, dtype=torch.float32)
    T, k = idx.shape
    if tuple(gates.shape) != (T, k):
        raise ValueError(f"gates {tuple(gates.shape)} do not match idx {(T, k)}")
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True).to(torch.int32)
    sorted_e = flat_e[order.long()].contiguous()
    e_ids = torch.arange(n_experts, dtype=torch.int32, device=dev)
    start = torch.searchsorted(sorted_e, e_ids, side="left", out_int32=True)
    loads = torch.searchsorted(sorted_e, e_ids, side="right", out_int32=True) - start
    return T, k, order, flat_t, flat_g, loads, start


def route_to_tasks_pool_torch(idx, gates, n_experts: int, bt: int = 8):
    """The shared-pool Put (the reference's ``route_to_tasks_pool_jax``), as
    torch ops on ``idx``'s device with no host sync.

    One flat pool of ``pool_tiles = ceil(T·k / bt) + E`` tiles holds every
    expert's tiles at the tile offset ``toff[e] = Σ_{e'<e} ceil(loads[e'] /
    bt)``; each expert wastes less than one tile, so the pool fits any
    routing, a token's repeated expert included.  Pool tile ``j`` owns
    routed rows ``[j·bt, (j+1)·bt)`` and is its own ``tid``.  Each output
    array is one gather per row (row ``row_off[e] + j`` holds pair
    ``order[start[e] + j]`` iff ``j < loads[e]``), as the reference builds
    it; rows past a segment's live prefix and the pool suffix are dead
    (token 0, gate 0, ``row_src = T·k``) and the suffix records are ⊥.

    Needs per-expert queues (queue ``e`` is the segment ``[toff[e],
    toff[e+1])``).  Returns ``(records [pool_tiles, TASK_WIDTH], tail [E],
    pool_off [E + 1], routed)`` as int32/float32 tensors, ``routed``'s
    arrays too (``expert_off = pool_off · bt``)."""
    E = n_experts
    T, k, order, flat_t, flat_g, loads, start = _group_by_expert_torch(idx, gates, E)
    dev = order.device
    Tk = T * k
    pool_tiles = _cdiv(Tk, bt) + E
    n_tiles = (loads + bt - 1) // bt
    toff = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      torch.cumsum(n_tiles, 0).to(torch.int32)])
    row_off = toff * bt
    n_rows = pool_tiles * bt

    def owner(tile):
        """The expert whose segment [toff[e], toff[e+1]) holds each tile (an
        empty expert's duplicate offset resolves to the next non-empty one)."""
        return torch.clamp(torch.searchsorted(toff, tile, side="right", out_int32=True) - 1,
                           0, E - 1).long()

    rows = torch.arange(n_rows, dtype=torch.int32, device=dev)
    tile_row = rows // bt
    e_row = owner(tile_row)
    j_row = rows - row_off[e_row]
    row_live = (tile_row < toff[E]) & (j_row < loads[e_row])
    pair = order[torch.clamp(start[e_row] + j_row, max=Tk - 1).long()]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    tok_idx = torch.where(row_live, flat_t[pair.long()], zero)
    gate_rows = torch.where(row_live, flat_g[pair.long()], torch.zeros((), device=dev))
    row_src = torch.where(row_live, pair, zero + Tk)

    j = torch.arange(pool_tiles, dtype=torch.int32, device=dev)
    e_of = owner(j)
    live = j < toff[E]
    rl = torch.where(live, torch.clamp(loads[e_of] - (j - toff[e_of]) * bt, 0, bt), zero)
    bot = zero + BOTTOM
    records = torch.stack([
        torch.where(live, zero + OP_EXPERT_TILE, bot), torch.where(live, e_of.int(), bot),
        j * bt, rl, bot.expand(pool_tiles), bot.expand(pool_tiles), j, rl,
    ], dim=-1)
    routed = RoutedSet(tok_idx=tok_idx, gates=gate_rows, expert_off=row_off, loads=loads,
                       n_rows=n_rows, n_routed=Tk, n_tokens=T, row_src=row_src)
    return records, n_tiles, toff, routed


def route_to_tasks_torch(idx, gates, n_experts: int, bt: int = 8,
                         max_expert_load: Optional[int] = None):
    """The padded device Put (the reference's ``route_to_tasks_jax``), as
    torch ops on ``idx``'s device with no host sync.

    Every expert owns ``R = ceil(cap / bt)·bt`` rows from ``e·R`` and ``R /
    bt`` candidate tiles with static ``tid = e·(R / bt) + i``, where ``cap =
    min(T·k, T)`` (top-k picks distinct experts, so an expert gets at most
    one pair a token) or ``max_expert_load``; the router's load moves only
    the live masks.  Row ``e·R + j`` holds pair ``order[start[e] + j]`` iff
    ``j < loads[e]`` (pairs past the provisioned range are dropped by the
    mask, as in the reference); tile ``(e, i)`` is live iff ``i·bt <
    loads[e]``, with ``row_len = cost = clip(loads[e] - i·bt, 0, bt)``.
    Dead rows point at token 0 with gate 0.  Returns ``(records [E, R / bt,
    TASK_WIDTH], live [E, R / bt], routed)``, ``routed``'s arrays tensors
    but ``expert_off``, the static ``e ↦ e·R`` (numpy).  Tile ``t`` owns rows
    ``[t·bt, (t+1)·bt)``, so the combine's divisor is the pool layout's."""
    E = n_experts
    T, k, order, flat_t, flat_g, loads, start = _group_by_expert_torch(idx, gates, E)
    dev = order.device
    Tk = T * k
    cap = min(Tk, T if max_expert_load is None else int(max_expert_load))
    tiles_per_e = _cdiv(cap, bt)
    R = tiles_per_e * bt
    rows = torch.arange(E * R, dtype=torch.int32, device=dev)
    e_row = (rows // R).long()
    j_row = rows - e_row.int() * R
    row_live = j_row < loads[e_row]
    pair = order[torch.clamp(start[e_row] + j_row, max=Tk - 1).long()]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    tok_idx = torch.where(row_live, flat_t[pair.long()], zero)
    gate_rows = torch.where(row_live, flat_g[pair.long()], torch.zeros((), device=dev))
    row_src = torch.where(row_live, pair, zero + Tk)

    e_ids = torch.arange(E, dtype=torch.int32, device=dev)[:, None]
    i_ids = torch.arange(tiles_per_e, dtype=torch.int32, device=dev)[None, :]
    rl = torch.clamp(loads[:, None] - i_ids * bt, 0, bt)
    shape = (E, tiles_per_e)
    bot = (zero + BOTTOM).expand(shape)
    records = torch.stack([
        (zero + OP_EXPERT_TILE).expand(shape), e_ids.expand(shape), e_ids * R + i_ids * bt,
        rl, bot, bot, e_ids * tiles_per_e + i_ids, rl,
    ], dim=-1)
    routed = RoutedSet(tok_idx=tok_idx, gates=gate_rows,
                       expert_off=np.arange(E + 1, dtype=np.int32) * R, loads=loads,
                       n_rows=E * R, n_routed=Tk, n_tokens=T, row_src=row_src)
    return records, rl > 0, routed


def expert_queue_candidates(records, live, n_queues: int):
    """Owner placement of the device Put's expert tiles: expert ``e`` lands
    on queue ``e % n_queues`` (per-expert queues when ``n_queues == E``, the
    static baseline's round-robin over programs when ``n_queues ==
    n_programs``), the keying of ``partition_tasks(partition="owner")``."""
    return owner_queue_candidates(records, live, n_queues)


def route_to_tasks_pool(idx, gates, n_experts: int, bt: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, RoutedSet]:
    """:func:`route_to_tasks_pool_torch` on the host, its arrays as numpy:
    the Put the training path and the backward feed to
    :func:`~repro_torch.pallas_ws.queues.make_pool_queue_state`."""
    records, tail, pool_off, routed = route_to_tasks_pool_torch(
        torch.from_numpy(np.asarray(idx, dtype=np.int32)),
        torch.from_numpy(np.asarray(gates, dtype=np.float32)), n_experts, bt=bt)
    routed = dataclasses.replace(routed, **{
        f: getattr(routed, f).numpy()
        for f in ("tok_idx", "gates", "expert_off", "loads", "row_src")})
    return records.numpy(), tail.numpy(), pool_off.numpy(), routed


def expert_rounds_bound(n_routed: int, bt: int, n_queues: int, n_programs: int,
                        steal: bool, steal_run_cap: int = 1) -> int:
    """Worst-case lockstep rounds to drain any routing of ``n_routed`` pairs
    (cost unit: routed rows).  Stealing: Graham's ``ceil(total/P) +
    max_cost`` on the worst admissible total (a tile costs at most ``bt``).
    No stealing: run compression drains each owner's queue in its first idle
    round, so the bound is O(1)."""
    if steal:
        return _cdiv(n_routed, n_programs) + max(1, steal_run_cap) * bt
    return STATIC_COMPRESSED_ROUNDS


def divisor_from_tiles(row_start, row_len, tile_mult, n_rows: int):
    """Per-row multiplicity divisor: tile ``i`` owns rows ``[row_start[i],
    row_start[i] + row_len[i])``, which get ``max(1, tile_mult[i])``; every
    other row gets 1.  An int ``row_len`` is the uniform tile height of the
    pool and padded device layouts: a live tile's pad rows get its divisor
    too (they hold 0).  A ``tile_mult`` tensor with an int ``row_len`` gives
    a float32 tensor on its device, by one indexed write of a static [n,
    bt] row grid (the reference's traced branch); otherwise numpy."""
    if isinstance(tile_mult, torch.Tensor) and isinstance(row_len, (int, np.integer)):
        bt = int(row_len)
        dev = tile_mult.device
        starts = torch.as_tensor(row_start).to(device=dev, dtype=torch.int64)
        rows = starts[:, None] + torch.arange(bt, device=dev)[None, :]
        m = torch.clamp(tile_mult, min=1).to(torch.float32)
        div = torch.ones((n_rows,), dtype=torch.float32, device=dev)
        div[rows.reshape(-1)] = m[:, None].expand(rows.shape).reshape(-1)
        return div
    starts = np.asarray(row_start, dtype=np.int64)
    lens = np.broadcast_to(np.asarray(row_len, dtype=np.int64), starts.shape)
    m = np.maximum(1, np.asarray(tile_mult)).astype(np.float32)
    div = np.ones((n_rows,), dtype=np.float32)
    total = int(lens.sum())
    if total:
        # concatenated aranges: [0..len0) ++ [0..len1) ++ ...
        offs = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        div[np.repeat(starts, lens) + offs] = np.repeat(m, lens)
    return div


def row_divisor(tasks: Sequence[ExpertTask], mult, n_rows: int) -> np.ndarray:
    """Per-row multiplicity divisor of a lockstep launch: each live row
    belongs to exactly one tile, so dividing its accumulated output by that
    tile's execution count is exact.  Pad rows keep divisor 1."""
    mult = np.asarray(mult)
    if not tasks:
        return np.ones((n_rows,), dtype=np.float32)
    starts = np.fromiter((t.row_start for t in tasks), np.int64, len(tasks))
    lens = np.fromiter((t.row_len for t in tasks), np.int64, len(tasks))
    tids = np.fromiter((t.tid for t in tasks), np.int64, len(tasks))
    return divisor_from_tiles(starts, lens, mult[tids], n_rows)
