"""Expert → device partitioning and the per-device pool Put (port of
``repro/mesh_ws/partition.py``).

The mesh layer shards the expert axis as the large configs do: device ``m``
owns the contiguous expert block ``[m·El, (m+1)·El)`` with ``El = E // D``.
Every device sees the *full* replicated routing ``(idx, gates)`` and Puts
only its own experts' pairs: a masked form of the shared-pool Put
(:func:`repro_torch.moe_ws.dispatch.route_to_tasks_pool_torch`) where the
foreign pairs land in a dead sacrificial bucket (gate 0, ``row_src =
T·k``), so shapes stay static and the foreign rows drop out of every
downstream reduction.

Expert ids inside the device pool are **local** (``0..El-1``), so the
device's weight shard ``[El, d, f]`` indexes directly, and a thief running
a stolen remote segment feeds the victim's shard, as the victim sent it, to the same
kernel unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.moe_ws.dispatch import RoutedSet
from repro_torch.pallas_ws.queues import QueueState, make_pool_queue_state
from repro_torch.pallas_ws.tasks import BOTTOM, OP_EXPERT_TILE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def expert_shard(n_experts: int, n_devices: int) -> int:
    """Experts per device; the partition is even or it is a config error."""
    if n_devices < 1:
        raise ValueError(f"need >= 1 device, got {n_devices}")
    if n_experts % n_devices:
        raise ValueError(f"n_experts={n_experts} not divisible by mesh size {n_devices}; "
                         "pick a mesh whose model axis divides the expert count")
    return n_experts // n_devices


class LocalPut(NamedTuple):
    """Tensors of one device's masked pool Put (all shapes static).

    ``records``/``tail``/``toff`` feed :func:`local_pool_state`;
    ``tile_expert``/``tile_index`` place each pool tile in its (local)
    expert segment, from which ``advisory.donated_cost`` re-derives the
    per-queue donated cost with no collective."""

    records: torch.Tensor      # [pool_tiles, 8] task rows, LOCAL expert ids
    tail: torch.Tensor         # [El] live tile count per local expert queue
    toff: torch.Tensor         # [El+2] tile-offset prefix (incl. the foreign block)
    routed: RoutedSet          # row-space views (tok_idx/gates/row_src/...)
    tile_expert: torch.Tensor  # [pool_tiles] owning local expert of tile j
    tile_index: torch.Tensor   # [pool_tiles] tile rank inside that segment


def route_local_pool_torch(idx, gates, n_experts: int, lo: int, n_local: int,
                           bt: int) -> LocalPut:
    """Masked per-device pool Put over experts ``[lo, lo + n_local)`` (the
    reference's ``route_local_pool_jax``), as torch ops on ``idx``'s device
    with no host sync.

    The shared-pool layout restricted to the local experts, plus one
    sacrificial bucket (key ``n_local``) holding every foreign pair: its
    rows get gate 0 and ``row_src = T·k``, so the pair-slot combine drops
    them, and its tiles are never recorded (``live = j < toff[n_local]``),
    so no queue serves them.  The pairs are grouped by a stable argsort of
    the key, as in the reference, and scattered to their rows: row
    ``row_off[key] + rank`` holds a pair (foreign rows keep their token).
    ``pool_tiles = cdiv(T·k, bt) + n_local + 1`` (every local expert half
    full, plus the foreign block); pool tile ``j`` owns rows ``[j·bt,
    (j+1)·bt)`` and is its own ``tid``."""
    idx = torch.as_tensor(idx).to(torch.int32)
    dev = idx.device
    gates = torch.as_tensor(gates).to(device=dev, dtype=torch.float32)
    T, k = idx.shape
    Tk = T * k
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    local = (flat_e >= lo) & (flat_e < lo + n_local)
    key = torch.where(local, flat_e - lo, n_local)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order].long()
    loads_all = torch.bincount(key.long(), minlength=n_local + 1).to(torch.int32)
    zero1 = torch.zeros(1, dtype=torch.int32, device=dev)
    start = torch.cat([zero1, torch.cumsum(loads_all, 0).to(torch.int32)[:-1]])
    rank = torch.arange(Tk, dtype=torch.int32, device=dev) - start[sorted_key]
    loads = loads_all[:n_local]

    pool_tiles = _cdiv(Tk, bt) + n_local + 1
    n_tiles = (loads_all + bt - 1) // bt
    toff = torch.cat([zero1, torch.cumsum(n_tiles, 0).to(torch.int32)])
    row_off = toff * bt                      # [El+2]; entry El = the foreign block
    dest = (row_off[sorted_key] + rank).long()
    n_rows = pool_tiles * bt
    loc_s = local[order]
    tok_idx = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    tok_idx[dest] = flat_t[order]
    gate_rows = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    gate_rows[dest] = torch.where(loc_s, flat_g[order], 0.0)
    row_src = torch.full((n_rows,), Tk, dtype=torch.int32, device=dev)
    row_src[dest] = torch.where(loc_s, order.to(torch.int32), Tk)

    j = torch.arange(pool_tiles, dtype=torch.int32, device=dev)
    tile_expert = torch.clamp(torch.searchsorted(toff, j, side="right", out_int32=True) - 1,
                              0, n_local - 1)
    tile_index = j - toff[tile_expert.long()]
    live = j < toff[n_local]
    rl = torch.where(live, torch.clamp(loads[tile_expert.long()] - tile_index * bt, 0, bt), 0)
    bot = torch.full((pool_tiles,), BOTTOM, dtype=torch.int32, device=dev)
    records = torch.stack([
        torch.where(live, OP_EXPERT_TILE, bot),
        torch.where(live, tile_expert, bot),    # LOCAL expert
        j * bt,     # row_start: tile j owns rows [j·bt, (j+1)·bt)
        rl,         # row_len
        bot, bot,
        j,          # tid == pool slot index
        rl,         # cost
    ], dim=-1).to(torch.int32)
    routed = RoutedSet(tok_idx=tok_idx, gates=gate_rows, expert_off=row_off[:n_local + 1],
                       loads=loads, n_rows=n_rows, n_routed=Tk, n_tokens=T, row_src=row_src)
    return LocalPut(records=records, tail=n_tiles[:n_local], toff=toff, routed=routed,
                    tile_expert=tile_expert, tile_index=tile_index)


def local_pool_state(put: LocalPut, n_programs: int) -> QueueState:
    """Fresh :class:`QueueState` over one device's local pool (the phase-1
    launch), the advisories initialised to the local experts' loads."""
    n_local = put.tail.shape[0]
    return make_pool_queue_state(put.records, put.tail, put.toff[:n_local + 1],
                                 put.routed.loads, n_programs,
                                 n_tasks=put.records.shape[0])
