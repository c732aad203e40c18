"""Per-device load advisories: coalesced summaries and their exchange (port
of ``repro/mesh_ws/advisory.py``).

Inside a device every program ranks steal victims from the plain-write
``remaining[q]`` advisory vector: stale reads cost ranking quality, never
correctness.  The mesh layer lifts the same contract one level: each device
*reduces* its advisory vector to one scalar (total remaining tile-slot cost)
after its local drain and exchanges that scalar over the mesh axis.  The
exchanged view is stale by construction, and that is fine for the
intra-device reason: advisories only *rank* victims; a thief's extraction
is bounded by the gathered head/tail state.

No atomics and no fences: the exchange is D − 1 point-to-point hops of a
ring over the axis's process group (gloo ``isend``/``irecv``, through a
host buffer, since gloo sends only CPU tensors) and sums are
``all_reduce(SUM)``, data-parallel collectives outside every kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import resolve_axis


def ring_allgather(x: torch.Tensor, axis, n_devices: int) -> torch.Tensor:
    """All-gather ``x`` along ``axis`` by D − 1 ring hops: returns ``[D,
    *x.shape]`` on x's device, row ``m`` holding device ``m``'s value.

    Written as an explicit ring (not ``all_gather``), so the traffic is
    exactly D − 1 hops of ``x`` a device: each hop sends the block received
    last to the next rank and receives one from the previous rank, staged
    through the host, so a rank holds at most two blocks there.  Blocks
    keep their dtype.  On one device the result is a view of ``x``, not a
    copy."""
    ax = resolve_axis(axis)
    if ax.size != n_devices:
        raise ValueError(f"axis {ax.name!r} has {ax.size} ranks, not {n_devices}")
    if n_devices == 1:
        return x.unsqueeze(0)
    me = ax.index
    buf = x.new_empty((n_devices,) + tuple(x.shape))
    buf[me] = x
    nxt, prv = ax.global_rank((me + 1) % n_devices), ax.global_rank((me - 1) % n_devices)
    cur = x.detach().to("cpu").contiguous()
    for i in range(n_devices - 1):
        got = torch.empty_like(cur)
        reqs = [dist.isend(cur, nxt, group=ax.group), dist.irecv(got, prv, group=ax.group)]
        for r in reqs:
            r.wait()
        buf[(me - i - 1) % n_devices] = got.to(x.device)
        cur = got
    return buf


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the axis, on every rank (a
    new tensor; gloo reduces CUDA tensors in place).  One rank: ``x``."""
    ax = resolve_axis(axis)
    if ax.group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
    return out


def reduce_advisory(remaining) -> torch.Tensor:
    """One device's load summary: total remaining advisory cost, clamped
    nonnegative per queue first (a stale-low queue must not cancel another
    queue's real load).  An int32 scalar tensor."""
    return torch.clamp(torch.as_tensor(remaining), min=0).sum().to(torch.int32)


def donated_cost(put, new_tail) -> torch.Tensor:
    """Coalesced advisory correction for donated segments.

    When the replicated steal plan truncates this device's queue tails from
    ``put.tail`` to ``new_tail``, the tiles in ``[new_tail[e], tail[e])``
    leave the owner's advisory scope: sum their cost a queue, ONE plain
    subtraction a queue a dispatch (costs are nonnegative, so ``max(r - Σc,
    0) == fold(max(· - c, 0))``).  ``[El]`` int32."""
    cost = put.records[:, 7]
    tail = put.tail
    te = put.tile_expert.long()
    donated = (put.tile_index >= new_tail[te]) & (put.tile_index < tail[te])
    n_local = tail.shape[0]
    return torch.zeros(n_local, dtype=torch.int32, device=cost.device).index_add_(
        0, te, torch.where(donated, cost, 0).to(torch.int32))


def apply_donation(remaining, don_cost) -> torch.Tensor:
    """The coalesced plain write: per-queue advisory minus donated cost."""
    return torch.clamp(torch.as_tensor(remaining) - don_cost, min=0)


def exchange_payload_bytes(*, n_devices: int, pool_tiles: int, n_local: int, n_rows: int,
                           n_routed: int, d: int, f: int) -> int:
    """Analytic per-device collective payload of one mesh dispatch step (the
    reference's formula: every fp32 weight shard ring-gathered).  The port
    ring-gathers the context alone and sends a victim's shard, in its own
    dtype, only to its thieves (:func:`~repro_torch.mesh_ws.steal.
    send_stolen_shards`), so it moves less than this.

    Counts what the ring moves: the advisory scalar plus the victim-side
    context (records, heads, tails, offsets, token rows, gates, weight
    shards), each over D − 1 hops, plus the two psum deliveries (stolen
    outputs and multiplicities, the pair buffer), a psum ≈ 2(D − 1)/D ·
    bytes on a ring."""
    hops = n_devices - 1
    i32, f32 = 4, 4
    gathered = (
        1 * i32                      # advisory scalar
        + pool_tiles * 8 * i32       # records
        + n_local * i32 * 3          # head, tail, toff (toff: n_local+1 ≈)
        + (n_local + 1) * i32
        + n_rows * (i32 + f32)       # tok_idx + gates
        + n_local * d * f * f32 * 2  # wg, wu shards
        + n_local * f * d * f32      # wd shard
    )
    psum_payload = (
        n_devices * n_rows * d * f32    # stolen-output delivery box
        + n_devices * pool_tiles * i32  # stolen-mult delivery box
        + (n_routed + 1) * d * f32      # pair-slot combine buffer
    )
    return hops * gathered + 2 * hops * (psum_payload // n_devices)
