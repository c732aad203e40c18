"""Ragged decode attention on the work-stealing tile scheduler (port of the
host-Put path of ``repro/pallas_ws/ragged.py``).

Only the live tiles are emitted (host side, where lengths are concrete),
laid out in the Fig. 7 queues partitioned by batch row, and drained by the
megakernel's thieves.  ``schedule="ws"`` steals; ``schedule="static"``
drains owner queues only (same kernel, same cost accounting).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .kernel import WSRunResult, run_ws_schedule
from .queues import QueueState, make_queue_state, queue_costs
from .tasks import emit_decode_tasks, multiplicity_divisor

SCHEDULES = ("ws", "static")


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


def normalized_out(res: WSRunResult, tasks, shape) -> torch.Tensor:
    """The exact attention output of a drained launch: lockstep's accumulated
    duplicates divided by their multiplicity; free mode's plain stores as
    they are (dividing them again would be wrong)."""
    if res.mode == "free":
        return res.out
    div = multiplicity_divisor(tasks, res.mult.cpu().numpy(), shape)
    return res.out / torch.from_numpy(div).to(res.out.device)[..., None]


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
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}: {schedule!r}")
    if steal_run_cap != 1:
        raise NotImplementedError("steal_run_cap > 1 is not ported yet")
    B, H, hd = q.shape
    S = k.shape[2]
    bk = min(bk, max(1, S))
    lengths = np.asarray(lengths, dtype=np.int64)
    if lengths.shape != (B,) or lengths.max(initial=0) > S:
        raise ValueError(f"lengths {lengths} do not fit B={B}, S={S}")
    if state is None:
        state = decode_queue_state(lengths, H, S, n_programs=n_programs,
                                   partition=partition, bk=bk)
    res = run_ws_schedule(
        state, q[:, :, None, :], k, v, causal=False, bq=1, bk=bk,
        steal=schedule == "ws", steal_policy=steal_policy, mode=mode, trace=trace,
    )
    _check_drained(state, res)
    out = normalized_out(res, state.task_list, (B, H, 1))[:, :, 0].to(q.dtype)
    if return_stats:
        return out, RaggedStats.from_run(schedule, state, res, steal_policy)
    return out


# ---------------------------------------------------------------------------
# dense oracle


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
