"""Ragged attention on the work-stealing tile scheduler (port of the
host-Put path of ``repro/pallas_ws/ragged.py``): the ragged prefill
(:func:`ragged_flash_attention`) and decode (:func:`ragged_decode_attention`)
entry points, their dense oracles, and the decode launch's static rounds
bound (:func:`decode_rounds_bound`).

Only the live tiles are emitted (host side, where lengths are concrete),
laid out in the Fig. 7 queues partitioned by batch row, and drained by the
megakernel's thieves.  ``schedule="ws"`` steals; ``schedule="static"``
drains owner queues only (same kernel, same cost accounting).
``steal_run_cap > 1`` (cost policy) lets a steal claim the victim's
half-run; the static schedule has no thieves and ignores it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .kernel import STATIC_COMPRESSED_ROUNDS, WSRunResult, run_ws_schedule
from .queues import QueueState, make_queue_state, queue_costs
from .tasks import emit_decode_tasks, emit_flash_tasks, multiplicity_divisor

SCHEDULES = ("ws", "static")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class RaggedStats:
    """Scheduling telemetry for one launch (units: kv-block tile-slots)."""

    schedule: str
    steal_policy: str
    n_tasks: int
    makespan: int
    total_work: int
    wasted_slots: int
    steals: int
    mult_max: int
    slots_scanned: int
    extractions: int
    scan_per_extraction: float
    queue_loads: list
    trace: object = None  # WSTrace when the launch recorded event rings

    @classmethod
    def from_run(cls, schedule, state, res: WSRunResult,
                 steal_policy: str = "cost") -> "RaggedStats":
        trace = None
        if res.events is not None:
            from ..wstrace.trace import WSTrace

            trace = WSTrace.from_run(state, res)
        return cls(
            schedule=schedule,
            steal_policy=steal_policy,
            n_tasks=state.n_tasks,
            makespan=res.makespan,
            total_work=res.total_work,
            wasted_slots=res.wasted_slots,
            steals=int(res.steals.sum()),
            mult_max=int(res.mult[: max(1, state.n_tasks)].max()) if state.n_tasks else 0,
            slots_scanned=res.slots_scanned,
            extractions=res.extractions,
            scan_per_extraction=round(res.scan_per_extraction, 3),
            queue_loads=[int(c) for c in queue_costs(state)],
            trace=trace,
        )


def _pad_to(x, axis: int, multiple: int):
    """``x`` zero-padded along ``axis`` to a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _check_drained(state, res: WSRunResult) -> None:
    if state.n_tasks and not bool((res.mult[: state.n_tasks] >= 1).all()):
        missing = int((res.mult[: state.n_tasks] == 0).sum())
        raise RuntimeError(
            f"scheduler under-provisioned: {missing}/{state.n_tasks} tasks "
            "never executed (rounds bound too small?)"
        )


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}: {schedule!r}")


def normalized_out(res: WSRunResult, tasks, shape) -> torch.Tensor:
    """The exact attention output of a drained launch: lockstep's accumulated
    duplicates divided by their multiplicity; free mode's plain stores as
    they are (dividing them again would be wrong)."""
    if res.mode == "free":
        return res.out
    div = multiplicity_divisor(tasks, res.mult.cpu().numpy(), shape)
    return res.out / torch.from_numpy(div).to(res.out.device)[..., None]


def ragged_flash_attention(
    q,
    k,
    v,
    lengths,
    *,
    causal: bool = True,
    schedule: str = "ws",
    steal_policy: str = "cost",
    steal_run_cap: int = 1,
    n_programs: int = 8,
    partition: str = "batch",
    bq: int = 32,
    bk: int = 32,
    mode: Optional[str] = None,
    return_stats: bool = False,
    trace: bool = False,
):
    """Ragged flash attention (the ragged prefill) through the megakernel.

    q: [B, H, S, hd]; k, v: [B, Hkv, S, hd] (any strides); lengths: [B] host
    ints.  Rows at or past ``lengths[b]`` return 0.  The output matches the
    dense length-masked :func:`ragged_attention_ref` up to fp32 accumulation
    order.  Nothing is padded: the kernel guards ``qpos < S`` and
    ``kpos < S`` itself.  ``trace=True`` records the launch's event rings
    and attaches the decoded :class:`~repro_torch.wstrace.WSTrace` to the
    returned stats.
    """
    _check_schedule(schedule)
    B, H, S, hd = q.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.shape != (B,) or lengths.max(initial=0) > S:
        raise ValueError(f"lengths {lengths} do not fit B={B}, S={S}")
    bq = min(bq, max(1, S))
    bk = min(bk, max(1, S))
    tasks = emit_flash_tasks(lengths, H, bq, bk, causal=causal)
    state = make_queue_state(tasks, n_programs, partition=partition)
    steal = schedule == "ws"
    res = run_ws_schedule(
        state, q, k, v, causal=causal, bq=bq, bk=bk, steal=steal, steal_policy=steal_policy,
        steal_run_cap=steal_run_cap if steal else 1, mode=mode, trace=trace,
    )
    _check_drained(state, res)
    out = normalized_out(res, tasks, (B, H, res.out.shape[2]))[:, :, :S].to(q.dtype)
    if return_stats:
        return out, RaggedStats.from_run(schedule, state, res, steal_policy)
    return out


def decode_rounds_bound(B: int, n_heads: int, S: int, bk: int,
                        n_queues: int, n_programs: int, steal: bool,
                        steal_run_cap: int = 1) -> int:
    """Static worst-case lockstep rounds of a decode launch with every slot at
    the full cache length ``S`` (cost unit: kv blocks).  Stealing: Graham's
    ``ceil(total/P) + max_cost``, the tail term ``steal_run_cap · max_cost``
    with half-run steals.  No stealing: run compression drains the owners in
    their first idle round."""
    blocks = max(1, _cdiv(S, bk))
    if steal:
        return _cdiv(B * n_heads * blocks, n_programs) + max(1, steal_run_cap) * blocks
    return STATIC_COMPRESSED_ROUNDS


def decode_queue_state(lengths, n_heads: int, S: int, *, n_programs: int = 8,
                       partition: str = "batch", bk: int = 64) -> QueueState:
    """The host Put of one decode launch: one task per live (b, h)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    bk = min(bk, max(1, S))
    return make_queue_state(emit_decode_tasks(lengths, n_heads, bk), n_programs,
                            partition=partition)


def ragged_decode_attention(
    q,
    k,
    v,
    lengths,
    *,
    schedule: str = "ws",
    steal_policy: str = "cost",
    steal_run_cap: int = 1,
    n_programs: int = 8,
    partition: str = "batch",
    bk: int = 64,
    mode: Optional[str] = None,
    state: Optional[QueueState] = None,
    return_stats: bool = False,
    trace: bool = False,
):
    """Single-token decode over ragged KV caches: q [B, H, hd] attends slots
    ``[0, lengths[b])`` of k, v [B, Hkv, S, hd] (any strides: a transposed
    view of a [B, S, Hkv, hd] cache is read in place).  Dead rows (length 0)
    return 0.  ``state`` may carry a Put already built for these lengths
    (:func:`decode_queue_state`, possibly on the device); each launch
    clones its mutable arrays, so one Put serves every layer of a step.
    ``trace=True`` records the launch's event rings and attaches the
    decoded :class:`~repro_torch.wstrace.WSTrace` to the returned stats.
    """
    _check_schedule(schedule)
    B, H, hd = q.shape
    S = k.shape[2]
    bk = min(bk, max(1, S))
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.shape != (B,) or lengths.max(initial=0) > S:
        raise ValueError(f"lengths {lengths} do not fit B={B}, S={S}")
    if state is None:
        state = decode_queue_state(lengths, H, S, n_programs=n_programs,
                                   partition=partition, bk=bk)
    steal = schedule == "ws"
    res = run_ws_schedule(
        state, q[:, :, None, :], k, v, causal=False, bq=1, bk=bk, steal=steal,
        steal_policy=steal_policy, steal_run_cap=steal_run_cap if steal else 1, mode=mode,
        trace=trace,
    )
    _check_drained(state, res)
    out = normalized_out(res, state.task_list, (B, H, 1))[:, :, 0].to(q.dtype)
    if return_stats:
        return out, RaggedStats.from_run(schedule, state, res, steal_policy)
    return out


# ---------------------------------------------------------------------------
# dense oracles


def ragged_attention_ref(q, k, v, lengths, *, causal: bool = True):
    """O(S^2) length-masked reference of :func:`ragged_flash_attention`: q
    [B, H, S, hd], k, v [B, Hkv, S, hd]; rows at or past ``lengths[b]`` are
    zero."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    kf = torch.repeat_interleave(k, G, dim=1).float()
    vf = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ln = torch.as_tensor(np.asarray(lengths), device=q.device)[:, None, None, None]
    mask = (kpos < ln) & (qpos < ln)
    if causal:
        mask = mask & (qpos >= kpos)
    s = torch.where(mask, s, torch.full_like(s, -torch.inf))
    pr = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # fully-masked rows -> 0
    out = torch.einsum("bhqk,bhkd->bhqd", pr, vf)
    row_live = qpos[:, 0][None, None, :, None] < ln
    return torch.where(row_live, out, torch.zeros_like(out)).to(q.dtype)


def ragged_decode_ref(q, k, v, lengths):
    """Decode oracle: q [B, H, hd] attends kv slots [0, lengths[b])."""
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = torch.repeat_interleave(k, G, dim=1).float()
    vf = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * hd ** -0.5
    kpos = torch.arange(S, device=q.device)[None, None, :]
    ln = torch.as_tensor(np.asarray(lengths), device=q.device)[:, None, None]
    s = torch.where(kpos < ln, s, torch.full_like(s, -torch.inf))
    pr = torch.softmax(s, dim=-1)
    pr = torch.nan_to_num(pr, nan=0.0)
    out = torch.einsum("bhs,bhsd->bhd", pr, vf)
    return torch.where(ln > 0, out, torch.zeros_like(out)).to(q.dtype)
