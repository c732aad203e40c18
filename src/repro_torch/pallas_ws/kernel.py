"""Fence-free work-stealing megakernel: the scheduler shared by every tile
family, and the attention family's wrapper and plain version (port of
``repro/pallas_ws/kernel.py``).

The TPU kernel is one ``pallas_call`` over the grid ``(rounds, P)``: the
scheduler shell ``_generic_ws_kernel`` (WS-WMULT Take/Steal with plain loads
and stores, ``ws_try_extract``/``_probe_slot``/``ws_account``) around a
tile body.  Here the shell is ``csrc/ws_sched.cuh``, templated over the
tile, and its Python mirror :class:`_PlainWalk`; :func:`scheduler_knobs`
and :func:`launch_grid` are the family-agnostic half of a launch.  The
attention family (tile body ``_attention_execute``) is the hand-written
CUDA kernel ``csrc/ws_attention.cu``, launched by :func:`launch_ws_grid`
for CUDA tensors, and :func:`plain_ws_grid`, whose walk mirrors the kernel
statement by statement, for CPU tensors.  The expert family lives in
``repro_torch.moe_ws.expert_kernel`` on the same two shared pieces.

``mode="lockstep"`` is the reference's semantics (Pallas interpret order):
one walker over ``(r, p)``, program innermost; integer arrays bit-equal to
the reference; ``out`` accumulates ``tile × mult``.  ``stage_open`` (the
stage-gated Put of :func:`~repro_torch.pallas_ws.queues.make_staged_queue_state`)
hides queue ``q`` from every probe until round ``stage_open[q]``; it needs
lockstep, since free CTAs have no rounds.  ``mode="free"`` (the
default) is the paper's setting: on the card, P CTAs run concurrently until
their views show every queue drained; ``out`` holds plain stores of whole
normalised tiles and multiplicity is summed from per-program rows, so a
free-mode ``out`` is never divided by ``mult``.  The plain version of free
mode serialises the programs round-robin, one extraction each.

``trace=True`` records every extraction in per-program event rings
(``WSRunResult.events``/``ev_cursor``, schema in
:mod:`repro_torch.wstrace.ring`) with plain stores: the kernels' traced
instantiation, and the same append in :class:`_PlainWalk`.  ``fault_plan``
(a :class:`repro_torch.chaos.FaultPlan`) injects its launch-time faults as
initial values: stalls in ``clock``, advisory corruption in ``remaining``.
A traced free launch also reads ``rounds`` as a per-program budget in
tile-slots (a CTA stops once its clock reaches it) and holds a stalled CTA
back before its first probe; the untraced free walk ignores both.

``steal_run_cap > 1`` (cost policy, stealing, no ``stage_open``) is the
reference's half-run Steal: a steal claims ``min(ceil(rem/2), cap)``
contiguous victim slots with one plain write to each bound and runs them back
to back, each accounted (and traced, ``EV_RUN`` = the run's length) on its
own, with one clamped advisory write for the run.  The kernels' ``HALFRUN``
instantiations and :class:`_PlainWalk` carry it; ``cap == 1`` is the
per-slot claim.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..wstrace.ring import (
    EV_COST,
    EV_KIND,
    EV_MULT,
    EV_OP,
    EV_PROG,
    EV_QUEUE,
    EV_ROUND,
    EV_RUN,
    EV_SLOT,
    EV_TID,
    EV_VICTIM,
    EVENT_WIDTH,
    KIND_STEAL_COST,
    KIND_STEAL_REMOTE,
    KIND_STEAL_SCAN,
    KIND_TAKE,
)
from .queues import QueueState, host_array, queue_costs
from .tasks import (
    BOTTOM,
    F_B,
    F_COST,
    F_H,
    F_KV,
    F_OP,
    F_QL,
    F_QS,
    F_TID,
    max_cost,
)

NEG_INF = -1e30
STEAL_POLICIES = ("cost", "scan")
MODES = ("lockstep", "free")

# Rounds the compressed no-steal drain needs (one slack round, as the reference).
STATIC_COMPRESSED_ROUNDS = 2

# A traced free launch holds a CTA with a stall of k tile-slots back for
# k * FREE_STALL_NS nanoseconds before its first probe.
FREE_STALL_NS = 100_000

# The trace arguments of every C entry point when a launch is not traced:
# null rings select the untraced instantiation.
NO_RING = (None, None, None, 0, 0, 0)

# Launches of each CUDA kernel in this process: the wrapper adds one where it
# launches, and nowhere else.
launches = {"ws_attention": 0, "ws_expert": 0, "ws_expert_grad": 0, "ws_unified": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass
class WSRunResult:
    """Post-launch queue/telemetry arrays, int32 tensors on the launch's device."""

    out: torch.Tensor         # the family's fp32 output ([B, H, Sq_out, hd] for attention)
    head: torch.Tensor        # [n_queues]
    local_head: torch.Tensor  # [n_programs, n_queues]
    taken: torch.Tensor       # [n_queues, capacity] (flat [pool_slots] on the pool layout)
    remaining: torch.Tensor   # [n_queues]
    clock: torch.Tensor       # [n_programs]
    work: torch.Tensor        # [n_programs]
    steals: torch.Tensor      # [n_programs]
    scanned: torch.Tensor     # [n_programs]
    mult: torch.Tensor        # [n_tasks] executions per task (free: summed rows)
    mode: str = "free"
    # event rings of a traced launch (None otherwise): [n_programs, cap,
    # EVENT_WIDTH] int32, -1 where unwritten, and the appends attempted
    events: Optional[torch.Tensor] = None
    ev_cursor: Optional[torch.Tensor] = None

    @property
    def makespan(self) -> int:
        return int(self.clock.max()) if self.clock.numel() else 0

    @property
    def total_work(self) -> int:
        return int(self.work.sum())

    @property
    def wasted_slots(self) -> int:
        return self.work.numel() * self.makespan - self.total_work

    @property
    def slots_scanned(self) -> int:
        return int(self.scanned.sum())

    @property
    def extractions(self) -> int:
        return int(self.mult.sum())

    @property
    def scan_per_extraction(self) -> float:
        return self.slots_scanned / max(1, self.extractions)


class DrainCounter:
    """A step's drain check, kept on the device.  Each launch over a device
    Put adds the live tasks it left unexecuted (``mult == 0``) and its live
    tasks into two int32 counts, with no read back to the host; the caller
    reads them once a step (:meth:`check`), next to the logits it reads
    anyway.  The host Put's callers check each launch at once instead."""

    def __init__(self, device):
        self.counts = torch.zeros(2, dtype=torch.int32, device=device)

    def reset(self) -> None:
        self.counts.zero_()

    def add(self, mult: torch.Tensor, live: torch.Tensor) -> None:
        """``live``: [n] bool over the launch's task ids ``0 .. n - 1``."""
        missing = (mult[: live.shape[0]] == 0) & live
        self.counts += torch.stack((missing, live)).sum(1, dtype=torch.int32)

    def check(self) -> None:
        """Read the counts (one host read) and raise where a task never ran."""
        missing, n_live = self.counts.tolist()
        if missing:
            raise RuntimeError(f"scheduler under-provisioned: {missing}/{n_live} tasks never "
                               "executed in this step (rounds bound too small?)")


def default_rounds(state: QueueState, steal: bool,
                   compress_runs: Optional[bool] = None,
                   steal_run_cap: int = 1) -> int:
    """Static upper bound on lockstep rounds to drain every queue: Graham's
    ``ceil(total/P) + max_cost`` with stealing, O(1) for the compressed
    no-steal drain, the heaviest queue otherwise."""
    compress = (not steal) if compress_runs is None else compress_runs
    costs = queue_costs(state)
    total = int(costs.sum())
    if total == 0:
        return 1
    mc = max_cost(state.task_list) if state.task_list else int(costs.max())
    if steal:
        return -(-total // state.n_programs) + max(1, steal_run_cap) * mc
    if compress:
        return STATIC_COMPRESSED_ROUNDS
    return int(costs.max())


# ---------------------------------------------------------------------------
# plain version


class _PlainWalk:
    """Python mirror of the scheduler in ``csrc/ws_sched.cuh``: the same
    functions over list copies of the int32 arrays, in the dense or the
    shared-pool layout (``arrs["pool_off"]``), optionally stage-gated
    (``arrs["stage_open"]``).  A subclass supplies the tile body
    ``execute(fq, fs, store=)``, as each CUDA kernel does, and reads its
    record with :meth:`rec`.  :meth:`enable_trace` turns on the event ring
    (the kernels' traced instantiation); ``run_cap > 1`` is the half-run
    Steal (the kernels' ``HALFRUN`` instantiation)."""

    run_cap = 1

    def __init__(self, arrs, *, steal, policy):
        self.pool_off = arrs["pool_off"].tolist() if "pool_off" in arrs else None
        self.stage_open = arrs["stage_open"].tolist() if "stage_open" in arrs else None
        self.tasks = arrs["tasks"].tolist()
        self.tail = arrs["tail"].tolist()
        self.head = arrs["head"].tolist()
        self.local_head = arrs["local_head"].tolist()
        self.taken = arrs["taken"].tolist()
        self.remaining = arrs["remaining"].tolist()
        self.clock = arrs["clock"].tolist()
        self.work = arrs["work"].tolist()
        self.steals = arrs["steals"].tolist()
        self.scanned = arrs["scanned"].tolist()
        self.mult = arrs["mult"].tolist()
        self.n_queues = len(self.head)
        self.capacity = len(self.tasks) if self.pool_off is not None else len(self.tasks[0])
        self.steal, self.policy = steal, policy
        self.events = None

    def enable_trace(self, events, ev_cursor, steal_kind, mult0=None):
        """Record every extraction into ``events`` [P, cap, EVENT_WIDTH]
        (numpy, written in place) and count appends in ``ev_cursor``;
        ``mult0`` is free mode's carried multiplicity."""
        self.events, self.ev_cursor = events, ev_cursor.tolist()
        self.steal_kind = steal_kind
        self.mult0 = None if mult0 is None else mult0.tolist()

    def slot(self, v, s):
        """Flat pool index of slot (v, s) (pool layout only)."""
        return self.pool_off[v] + s

    def rec(self, v, s):
        """The task record at queue slot (v, s)."""
        return self.tasks[self.slot(v, s)] if self.pool_off is not None else self.tasks[v][s]

    def arrays(self):
        names = ("head", "local_head", "taken", "remaining", "clock", "work",
                 "steals", "scanned", "mult")
        out = {n: np.asarray(getattr(self, n), dtype=np.int32) for n in names}
        if self.events is not None:
            out["events"] = self.events
            out["ev_cursor"] = np.asarray(self.ev_cursor, dtype=np.int32)
        return out

    # -- scheduler ------------------------------------------------------------
    def rmax_read(self, p, v):
        return max(self.local_head[p][v], self.head[v])

    def probe(self, v, h, want):
        # pool: a read past tail[v] would land in the next queue's segment
        bound = self.tail[v] if self.pool_off is not None else self.capacity
        issue = want and h < bound
        return (self.rec(v, h)[F_OP] if issue else BOTTOM), int(issue)

    def claim_writes(self, p, v, h, take=1):
        self.head[v] = h + take
        self.local_head[p][v] = h + take

    def is_open(self, v, r):
        return self.stage_open is None or self.stage_open[v] <= r

    def scan_extract(self, p, r):
        found, fq, fs, nread = False, 0, 0, 0
        for j in range(self.n_queues if self.steal else 1):
            v = (p + j) % self.n_queues
            h = self.rmax_read(p, v)
            op, issued = self.probe(v, h, not found and self.is_open(v, r))
            live = op != BOTTOM
            if not found and live:
                self.claim_writes(p, v, h)
                fq, fs = v, h
            found = found or live
            nread += issued
        return found, fq, fs, nread, 1

    def cost_extract(self, p, r, lo, hi, rotate=False):
        """``[lo, hi)`` holds every queue that can score: queues below
        ``lo`` are drained for every view, those from ``hi`` on not open yet.
        With ``run_cap > 1`` a steal claims the victim's half-run
        ``[h, h + take)``, ``take = clip((tail - h + 1) // 2, 1, run_cap)``:
        the probe of slot ``h`` certifies it, since every slot below the
        tail is live.  ``rotate`` (the expert kernels' free walks, ``ROT`` in
        ``csrc/ws_sched.cuh``) visits every queue from ``p * n_queues // P``
        on, wrapping, so equal scores go to the first queue in p's
        rotation; free mode has no stage gate, so it tests no
        ``stage_open``.  Returns ``(found, queue, slot, nread, run)``."""
        own = p % self.n_queues
        h0 = self.rmax_read(p, own)
        op0, issued0 = self.probe(own, h0, self.is_open(own, r))
        own_live = op0 != BOTTOM
        if own_live:
            self.claim_writes(p, own, h0)
        if not self.steal:
            return own_live, own, h0, issued0, 1
        best_v, best, best_h = 0, 0, 0
        n = self.n_queues
        if rotate and self.stage_open is not None:
            raise ValueError("the rotated argmax is free mode's, which has no stage gate")
        order = ([(p * n // len(self.clock) + j) % n for j in range(n)] if rotate
                 else range(lo, hi))
        for j, v in enumerate(order):
            h = self.rmax_read(p, v)
            score = (max(self.remaining[v], 1)
                     if h < self.tail[v] and (rotate or self.is_open(v, r)) else 0)
            if j == 0 or score > best:  # first-index argmax (in p's rotation)
                best_v, best, best_h = v, score, h
        can = (not own_live) and best > 0
        op, issued = self.probe(best_v, best_h, can)
        live = can and op != BOTTOM
        take = 1
        if live and self.run_cap > 1:
            take = min(max((self.tail[best_v] - best_h + 1) // 2, 1), self.run_cap)
        if live:
            self.claim_writes(p, best_v, best_h, take)
        return (own_live or live, own if own_live else best_v,
                h0 if own_live else best_h, issued0 + issued, take if live else 1)

    def extract(self, p, r=0, lo=0, hi=None, rotate=False):
        if self.policy == "scan":
            return self.scan_extract(p, r)
        return self.cost_extract(p, r, lo, self.n_queues if hi is None else hi, rotate)

    def account(self, r, p, fq, fs, *, advisory, free, run=1):
        rec = self.rec(fq, fs)
        tid, cost = rec[F_TID], rec[F_COST]
        # the execution's start, read before the clock bump
        t0 = self.clock[p] if free else max(self.clock[p], r)
        if free:
            self.mult[p][tid] += 1
        else:
            self.mult[tid] += 1
        if self.pool_off is not None:
            self.taken[self.slot(fq, fs)] = p
        else:
            self.taken[fq][fs] = p
        if advisory:
            self.remaining[fq] = max(self.remaining[fq] - cost, 0)
        self.work[p] += cost
        self.steals[p] += int(fq != p % self.n_queues)
        self.clock[p] = self.clock[p] + cost if free else max(self.clock[p], r) + cost
        if self.events is not None:
            m = self.mult0[tid] + self.mult[p][tid] if free else self.mult[tid]
            self.trace_append(p, fq, rec, fs, t0, m, run)
        return cost

    def trace_append(self, p, fq, rec, fs, t0, m, run=1):
        """One record into program p's ring row (dropped past capacity; the
        cursor keeps counting)."""
        is_steal = fq != p % self.n_queues
        if self.steal_kind == KIND_STEAL_REMOTE:
            kind = KIND_STEAL_REMOTE
        else:
            kind = self.steal_kind if is_steal else KIND_TAKE
        c = self.ev_cursor[p]
        if c < self.events.shape[1]:
            ev = self.events[p, c]
            ev[EV_ROUND], ev[EV_PROG], ev[EV_QUEUE], ev[EV_SLOT] = t0, p, fq, fs
            ev[EV_TID], ev[EV_COST], ev[EV_KIND] = rec[F_TID], rec[F_COST], kind
            ev[EV_VICTIM] = fq if is_steal and fq < len(self.clock) else -1
            ev[EV_MULT], ev[EV_OP], ev[EV_RUN] = m, rec[F_OP], run
        self.ev_cursor[p] = c + 1

    def execute(self, fq, fs, *, store):
        raise NotImplementedError

    def execute_claim(self, r, p, fq, fs, run, *, free):
        """Run and account one claim.  Per-slot (``run_cap == 1``): the
        slot with its own advisory write.  Half-run: the run's slots back to
        back, each accounted without the advisory write, then one clamped
        write for the run (the reference's ``_execute_run``)."""
        if self.run_cap == 1:
            self.execute(fq, fs, store=free)
            self.account(r, p, fq, fs, advisory=True, free=free)
            return
        total = 0
        for i in range(run):
            self.execute(fq, fs + i, store=free)
            total += self.account(r, p, fq, fs + i, advisory=False, free=free, run=run)
        self.remaining[fq] = max(self.remaining[fq] - total, 0)

    # -- the two walks ----------------------------------------------------------
    def lockstep(self, rounds, P, compress):
        # The victim window [lo, hi): the single walker's heads only grow, so
        # a queue with head >= tail stays drained for every view, and
        # stage_open is nondecreasing, so queues from hi on are closed.
        # Skipping them leaves the first-index argmax and every count as
        # the full scan has them.
        lo = 0
        hi = 0 if self.stage_open is not None else self.n_queues
        for r in range(rounds):
            while hi < self.n_queues and self.stage_open[hi] <= r:
                hi += 1
            for p in range(P):
                if compress:
                    self._drain_run(r, p)
                    continue
                if self.clock[p] > r:
                    continue
                # a run claim moves head[v] at most to tail[v]: the window holds
                while lo < hi and self.head[lo] >= self.tail[lo]:
                    lo += 1
                found, fq, fs, nread, run = self.extract(p, r, lo, hi)
                self.scanned[p] += nread
                if found:
                    self.execute_claim(r, p, fq, fs, run, free=False)

    def _drain_run(self, r, p):
        if self.clock[p] > r:
            return
        own = p % self.n_queues

        def probe_own():
            h = self.rmax_read(p, own)
            op, issued = self.probe(own, h, True)
            self.scanned[p] += issued
            return op != BOTTOM, h

        live, h = probe_own()
        total = 0
        while live:
            self.claim_writes(p, own, h)
            self.execute(own, h, store=False)
            total += self.account(r, p, own, h, advisory=False, free=False)
            live, h = probe_own()
        if total > 0:
            self.remaining[own] = max(self.remaining[own] - total, 0)

    def free(self, P, budget=0, rotate=False):
        """Round-robin over the programs, one extraction a turn, until every
        view shows the queues drained.  Traced (as the kernel's traced
        instantiation): a program with an initial clock of k (a stall) sits
        out its first k turns, and stops once its clock reaches a positive
        ``budget`` (checked per extraction: a run may overshoot it).
        ``rotate``: the victim argmax's ties in p's rotation."""
        active = [True] * P
        traced = self.events is not None
        wait = list(self.clock) if traced else [0] * P
        while any(active):
            for p in range(P):
                if not active[p]:
                    continue
                if wait[p] > 0:
                    wait[p] -= 1
                    continue
                if traced and budget > 0 and self.clock[p] >= budget:
                    active[p] = False
                    continue
                found, fq, fs, nread, run = self.extract(p, rotate=rotate)
                self.scanned[p] += nread
                if not found:
                    active[p] = False
                    continue
                self.execute_claim(0, p, fq, fs, run, free=True)


class _AttentionWalk(_PlainWalk):
    """The plain version of ``csrc/ws_attention.cu``: the shared walk with
    the attention tile in torch fp32 on the tensors' device."""

    def __init__(self, arrs, q, k, v, out, *, steal, policy, bq, bk, causal,
                 scale, g):
        super().__init__(arrs, steal=steal, policy=policy)
        self.q, self.k, self.v, self.out = q, k, v, out
        self.bq, self.bk, self.causal, self.scale, self.g = bq, bk, causal, scale, g

    def execute(self, fq, fs, *, store):
        attention_tile(self.rec(fq, fs), self.q, self.k, self.v, self.out, bq=self.bq,
                       bk=self.bk, causal=self.causal, scale=self.scale, g=self.g,
                       store=store)


def attention_tile(rec, q, k, v, out, *, bq, bk, causal, scale, g, store) -> None:
    """The plain attention tile body of record ``rec``: ``bq`` query rows of
    ``(b, h)`` against kv head ``h // g`` of q [B, H, Sq, hd] and k, v
    [B, Hkv, Sk, hd] (any strides), into ``out[b, h, qs:qs+bq]`` fp32."""
    b, h, qs, ql = rec[F_B], rec[F_H], rec[F_QS], rec[F_QL]
    kv_end, cost = rec[F_KV], rec[F_COST]
    kh = h // g
    Sq, Sk, hd = q.shape[2], k.shape[2], q.shape[3]
    dev = q.device
    qt = torch.zeros((bq, hd), dtype=torch.float32, device=dev)
    n = max(0, min(bq, Sq - qs))
    qt[:n] = q[b, h, qs:qs + n].float()
    m = torch.full((bq,), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bq,), dtype=torch.float32, device=dev)
    acc = torch.zeros((bq, hd), dtype=torch.float32, device=dev)
    rows = torch.arange(bq, device=dev)[:, None]
    for ki in range(cost):
        k0 = ki * bk
        nk = max(0, min(bk, Sk - k0))
        kt = torch.zeros((bk, hd), dtype=torch.float32, device=dev)
        vt = torch.zeros((bk, hd), dtype=torch.float32, device=dev)
        kt[:nk] = k[b, kh, k0:k0 + nk].float()
        vt[:nk] = v[b, kh, k0:k0 + nk].float()
        s = (qt @ kt.T) * scale
        kpos = k0 + torch.arange(bk, device=dev)[None, :]
        valid = kpos < kv_end
        if causal:
            valid = valid & (kpos <= qs + rows)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.max(dim=1).values)
        pexp = torch.exp(s - m_new[:, None])
        corr = torch.exp(m - m_new)
        l = l * corr + pexp.sum(dim=1)
        acc = acc * corr[:, None] + pexp @ vt
        m = m_new
    tile = acc / torch.clamp(l, min=1e-30)[:, None]
    tile[ql:] = 0.0
    if store:
        out[b, h, qs:qs + bq] = tile
    else:
        out[b, h, qs:qs + bq] += tile


# ---------------------------------------------------------------------------
# launch


def _check_records(tasks: np.ndarray, *, B, H, sq_out, bq, n_tasks) -> None:
    """The kernel indexes q/out/mult with the live records' fields: reject a
    host-built record that would read or write out of bounds."""
    live = tasks[tasks[..., F_OP] != BOTTOM]
    if not live.size:
        return
    bad = ((live[:, F_B] < 0) | (live[:, F_B] >= B) | (live[:, F_H] < 0)
           | (live[:, F_H] >= H) | (live[:, F_QS] < 0) | (live[:, F_QS] + bq > sq_out)
           | (live[:, F_TID] < 0) | (live[:, F_TID] >= n_tasks) | (live[:, F_COST] < 0))
    if bad.any():
        raise ValueError(f"task record out of range for B={B}, H={H}, Sq={sq_out}: "
                         f"{live[bad][0].tolist()}")


def queue_dims(arrs):
    """``(n_queues, capacity, n_programs)`` of a launch's arrays, either layout:
    the capacity bounds slot indices per queue (dense) or over the pool."""
    cap = arrs["tasks"].shape[0] if "pool_off" in arrs else arrs["tasks"].shape[1]
    return arrs["head"].shape[0], cap, arrs["clock"].shape[0]


def scheduler_knobs(*, steal, steal_policy, steal_run_cap, mode, compress_runs,
                    stage_open=None):
    """Check the scheduler's knobs (every family); returns ``(mode, compress)``.
    ``steal_run_cap > 1`` (half-run steals) needs stealing under the cost
    policy and no ``stage_open``, as in the reference."""
    if steal_run_cap < 1:
        raise ValueError(f"steal_run_cap must be >= 1, got {steal_run_cap}")
    if steal_run_cap > 1:
        if not steal or steal_policy != "cost":
            raise ValueError("steal_run_cap > 1 amortizes cost-policy steals: needs "
                             "steal=True, steal_policy='cost'")
        if stage_open is not None:
            raise ValueError("steal_run_cap > 1 breaks the per-slot-claim assumption of "
                             "stage_open's Graham windows")
    if steal_policy not in STEAL_POLICIES:
        raise ValueError(f"steal_policy must be one of {STEAL_POLICIES}: {steal_policy!r}")
    mode = "free" if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    compress = (not steal) if compress_runs is None else compress_runs
    if compress and steal:
        raise ValueError("compress_runs models the no-steal schedule only")
    if stage_open is not None:
        if compress:
            raise ValueError("stage_open needs the per-round lockstep (compress_runs=False)")
        if mode != "lockstep":
            raise ValueError("stage_open gates queues by round; free mode has no rounds")
        so = np.asarray(stage_open)
        if so.ndim != 1 or (so.size > 1 and (np.diff(so) < 0).any()):
            raise ValueError("stage_open must be a nondecreasing [n_queues] vector "
                             "(the stage-major layout of make_staged_queue_state)")
    return mode, compress


def launch_grid(state: QueueState, out, *, walk, launch, plain: bool, mode: str,
                compress: bool, steal: bool, steal_policy: str, rounds, mult,
                stage_open=None, trace: bool = False, trace_capacity=None,
                trace_remote: bool = False, fault_plan=None,
                steal_run_cap: int = 1, rotate_ties: bool = False) -> WSRunResult:
    """The family-agnostic half of a launch: fresh copies of the mutable queue
    arrays on ``out``'s device, then the plain walk (``walk(host_arrays,
    steal=, policy=)`` returns a :class:`_PlainWalk`) or the CUDA kernel
    (``launch(arrays, mode=, rounds=, steal=, policy=, compress=, n_tasks=,
    ring=, run_cap=)``) over them.  A shared-pool state adds ``arrays["pool_off"]``, a
    stage-gated launch ``arrays["stage_open"]``.  Free mode's per-program
    multiplicity rows are summed here.

    ``trace`` allocates the event rings (``arrays["events"]``,
    ``["ev_cursor"]``; ``ring`` is then the entry points' six trace
    arguments, else :data:`NO_RING`).  Their default capacity is the
    per-program claim bound: ``rounds + steal_run_cap - 1`` in lockstep (one
    claim a round, and a run of n slots keeps its program busy n rounds, so
    only the last run can overshoot), the queue capacity for compressed
    drains, and in free mode the live slots Σtail (a program claims each slot
    at most once a launch, runs included: its local bound only grows).
    ``trace_remote`` tags every event ``steal-remote``.  ``fault_plan``
    applies its launch faults as initial values, as the reference does: the
    plan's ``remaining`` and stall clocks, with ``rounds`` (when not given)
    extended by the largest stall.  ``rotate_ties`` (the expert families,
    whose kernels' free walks rotate) breaks the plain free walk's victim
    ties in each program's rotation; lockstep ignores it."""
    dev = out.device
    P = state.n_programs
    n_tasks = max(1, state.n_tasks)
    if mult is not None and tuple(mult.shape) != (n_tasks,):
        raise ValueError(f"carried mult has shape {tuple(mult.shape)}, expected ({n_tasks},)")
    rounds_given = rounds is not None
    if mode == "lockstep" and rounds is None:
        rounds = default_rounds(state, steal, compress_runs=compress,
                                steal_run_cap=steal_run_cap)
    remaining = state.remaining
    if remaining is None:
        remaining = queue_costs(state)
    # a device state's arrays are tensors on ``dev`` already: the launch
    # arrays below are device copies of them, with nothing read to the host
    clock0 = torch.zeros(P, dtype=torch.int32, device=dev)
    if fault_plan is not None:
        # chaos injection is data: a stalled program is a nonzero initial
        # clock, a stale advisory a different initial value
        remaining = fault_plan.launch_remaining(host_array(remaining))
        if fault_plan.max_stall:
            clock0 = fault_plan.stall_vector(P)
            if not rounds_given and mode == "lockstep":
                rounds += fault_plan.max_stall

    def i32(a, fresh):
        t = torch.as_tensor(a, dtype=torch.int32, device=dev)
        return t.clone() if fresh else t.contiguous()

    arrs = {
        "tasks": i32(state.tasks, False),
        "tail": i32(state.tail, False),
        "head": i32(state.head, True),
        "local_head": i32(state.local_head, True),
        "taken": i32(state.taken, True),
        "remaining": i32(remaining, True),
        **({"pool_off": i32(state.pool_off, False)} if state.pool else {}),
        **({"stage_open": i32(stage_open, False)} if stage_open is not None else {}),
        "clock": i32(clock0, True),
        "work": torch.zeros(P, dtype=torch.int32, device=dev),
        "steals": torch.zeros(P, dtype=torch.int32, device=dev),
        "scanned": torch.zeros(P, dtype=torch.int32, device=dev),
    }
    mult0 = (torch.zeros(n_tasks, dtype=torch.int32, device=dev) if mult is None
             else i32(mult, True))
    arrs["mult"] = (mult0 if mode == "lockstep"
                    else torch.zeros((P, n_tasks), dtype=torch.int32, device=dev))
    ring = NO_RING
    if trace:
        if trace_capacity is None:
            trace_capacity = (state.capacity if compress
                              else rounds + steal_run_cap - 1 if mode == "lockstep"
                              else max(1, int(host_array(state.tail).sum())))
        steal_kind = (KIND_STEAL_REMOTE if trace_remote else
                      KIND_STEAL_SCAN if steal_policy == "scan" else KIND_STEAL_COST)
        arrs["events"] = torch.full((P, trace_capacity, EVENT_WIDTH), -1, dtype=torch.int32,
                                    device=dev)
        arrs["ev_cursor"] = torch.zeros(P, dtype=torch.int32, device=dev)
        free_mult0 = mode == "free"
        ring = (arrs["events"].data_ptr(), arrs["ev_cursor"].data_ptr(),
                mult0.data_ptr() if free_mult0 else None, trace_capacity, steal_kind,
                FREE_STALL_NS)
    if plain:
        w = walk({n: a.cpu().numpy() for n, a in arrs.items() if n not in ("events", "ev_cursor")},
                 steal=steal, policy=steal_policy)
        w.run_cap = steal_run_cap
        if trace:
            w.enable_trace(arrs["events"].cpu().numpy(), arrs["ev_cursor"].cpu().numpy(),
                           steal_kind, mult0.cpu().numpy() if free_mult0 else None)
        if mode == "lockstep":
            w.lockstep(rounds, P, compress)
        else:
            w.free(P, budget=rounds or 0, rotate=rotate_ties)
        for n, a in w.arrays().items():
            arrs[n].copy_(torch.from_numpy(a))
    else:
        launch(arrs, mode=mode, rounds=rounds or 0, steal=steal, policy=steal_policy,
               compress=compress, n_tasks=n_tasks, ring=ring, run_cap=steal_run_cap)
    total_mult = arrs["mult"] if mode == "lockstep" else mult0 + arrs["mult"].sum(0, dtype=torch.int32)
    return WSRunResult(
        out=out, head=arrs["head"], local_head=arrs["local_head"],
        taken=arrs["taken"], remaining=arrs["remaining"], clock=arrs["clock"],
        work=arrs["work"], steals=arrs["steals"], scanned=arrs["scanned"],
        mult=total_mult, mode=mode, events=arrs.get("events"),
        ev_cursor=arrs.get("ev_cursor"),
    )


def _run(state: QueueState, q, k, v, out, *, bq, bk, causal, scale, plain: bool,
         steal=True, steal_policy="cost", steal_run_cap=1, rounds=None,
         mult=None, compress_runs=None, mode=None, stage_open=None,
         trace=False, trace_capacity=None, trace_remote=False,
         fault_plan=None) -> WSRunResult:
    mode, compress = scheduler_knobs(
        steal=steal, steal_policy=steal_policy, steal_run_cap=steal_run_cap, mode=mode,
        compress_runs=compress_runs, stage_open=stage_open)
    dev = q.device
    if state.pool:
        raise NotImplementedError("the attention family runs on the dense layout; the "
                                  "shared pool is the expert families'")
    if not (k.device == v.device == out.device == dev):
        raise ValueError("q, k, v and out must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share dtype float32 or bfloat16: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if (out.dtype != torch.float32 or not out.is_contiguous()
            or out.shape[:2] != (B, H) or out.shape[3] != hd
            or out.shape[2] % bq or out.shape[2] < Sq):
        raise ValueError(f"out must be contiguous float32 [B, H, Sq padded to bq, hd]: "
                         f"{out.dtype} {tuple(out.shape)}")
    if isinstance(state.tasks, np.ndarray):
        _check_records(state.tasks, B=B, H=H, sq_out=out.shape[2], bq=bq,
                       n_tasks=max(1, state.n_tasks))
    g = H // Hkv

    def walk(arrs, **kw):
        return _AttentionWalk(arrs, q, k, v, out, bq=bq, bk=bk, causal=causal,
                              scale=scale, g=g, **kw)

    def launch(arrs, **kw):
        _launch_cuda(arrs, q, k, v, out, causal=causal, bq=bq, bk=bk, scale=scale,
                     g=g, **kw)

    return launch_grid(state, out, walk=walk, launch=launch, plain=plain, mode=mode,
                       compress=compress, steal=steal, steal_policy=steal_policy,
                       rounds=rounds, mult=mult, stage_open=stage_open, trace=trace,
                       trace_capacity=trace_capacity, trace_remote=trace_remote,
                       fault_plan=fault_plan, steal_run_cap=steal_run_cap)


# The six trace arguments every C entry point takes before its stream:
# events, ev_cursor, free mode's carried mult, capacity, steal kind, stall ns.
RING_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3


def _kernel_fn():
    """The C entry point of ``csrc/ws_attention.cu`` (built at first use)."""
    from .. import _build

    fn = _build.load("ws_attention").ws_attention_launch
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # mode, dtype; 12 int32 arrays (stage_open may be null); q, k, v,
        # out; strides; 10 sizes and flags (run_cap among them); 8 shape
        # ints and the branch; scale; the ring; stream
        fn.argtypes = ([i, i] + [ptr] * 12 + [ptr] * 4 + [ptr]
                       + [i] * 10 + [i] * 9 + [ctypes.c_float] + RING_ARGTYPES + [ptr])
        fn.restype = i
    return fn


# The tile bodies of csrc/ws_attention.cu (its module comment has the
# design): (a) decode GEMV, (b) bf16 flash tiles on mma.sync, (c) the first
# fp32 tile body.  The kernel's geometry: 8 warps; branch (b) keeps head
# dims up to MMA_HD in registers and gives each kv split KW keys a stage.
BRANCHES = ("decode", "mma", "generic")
NWARPS = 8
MMA_HD = 128
KW = 16


def vector_rows(t: torch.Tensor) -> bool:
    """Whether ``t`` ([.., rows, hd]) reads as rows of 16-byte vectors: unit
    inner stride, a 16-byte aligned base and outer strides."""
    *outer, inner = t.stride()
    size = t.element_size()
    return (inner == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in outer))


def attention_branch(q, k, v, bq: int) -> str:
    """The tile body a launch runs, from the inputs' dtype, head dim and
    layouts and the tile's ``bq`` (a pure function of their metadata):
    ``"decode"`` for bq 1 over 16-byte K/V rows (hd % 8 == 0, <= 256);
    ``"mma"`` for bf16 tiles of bq a multiple of 16 (<= 128) over 16-byte
    q/K/V rows (hd % 16 == 0, <= MMA_HD); ``"generic"`` otherwise."""
    hd = q.shape[-1]
    kv_rows = vector_rows(k) and vector_rows(v)
    if bq == 1 and hd % 8 == 0 and hd <= 256 and kv_rows:
        return "decode"
    if (q.dtype == torch.bfloat16 and bq % 16 == 0 and 16 <= bq <= 16 * NWARPS
            and hd % 16 == 0 and hd <= MMA_HD and kv_rows and vector_rows(q)):
        return "mma"
    return "generic"


def smem_bytes(branch: str, bq: int, bk: int, hd: int) -> int:
    """Dynamic shared memory of one CTA of ``csrc/ws_attention.cu`` running
    ``branch`` (its ``tile_smem``): (a) the warps' partials; (b) the K/V
    ring of two stages of KW keys a kv split and the q tile (bf16 rows
    padded by 8), or the splits' partials, whichever is larger; (c) the fp32
    tile body's q, accumulator, K/V block (rows padded by one), scores and
    row statistics."""
    if branch == "decode":
        return 4 * NWARPS * (hd + 2)
    if branch == "mma":
        kc = KW * (NWARPS // (bq // 16))
        return max(2 * (4 * kc + bq) * (hd + 8), 4 * NWARPS * 16 * (hd + 2))
    return 4 * (2 * bq * hd + bk * (hd + 1) + bq * bk + 3 * bq)


def _launch_cuda(arrs, q, k, v, out, *, mode, rounds, steal, policy, compress,
                 causal, bq, bk, scale, g, n_tasks, ring=NO_RING, run_cap=1) -> None:
    from ..kernels._launch import check_smem

    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    branch = attention_branch(q, k, v, bq)
    check_smem(f"ws_attention ({branch} tiles, bq={bq}, bk={bk}, hd={hd})",
               smem_bytes(branch, bq, bk, hd))
    fn = _kernel_fn()
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    names = ("tasks", "tail", "head", "local_head", "taken", "remaining", "clock",
             "work", "steals", "scanned", "mult")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        MODES.index(mode), 1 if q.dtype == torch.bfloat16 else 0,
        *[arrs[n].data_ptr() for n in names],
        arrs["stage_open"].data_ptr() if "stage_open" in arrs else None,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.cast(strides, ctypes.c_void_p),
        *queue_dims(arrs), n_tasks, rounds, int(steal), STEAL_POLICIES.index(policy), int(compress),
        run_cap, int(causal),
        H, Sq, out.shape[2], Sk, hd, g, bq, bk, BRANCHES.index(branch), float(scale), *ring,
        stream,
    )
    launches["ws_attention"] += 1
    if err != 0:
        raise RuntimeError(f"ws_attention launch failed with CUDA error {err}")


def launch_ws_grid(state: QueueState, q, k, v, out, *, bq: int, bk: int,
                   causal: bool, scale: float, steal: bool = True,
                   steal_policy: str = "cost", steal_run_cap: int = 1,
                   rounds: Optional[int] = None, mult=None,
                   compress_runs: Optional[bool] = None, mode: Optional[str] = None,
                   stage_open=None, trace: bool = False,
                   trace_capacity: Optional[int] = None, trace_remote: bool = False,
                   fault_plan=None) -> WSRunResult:
    """Run the work-stealing grid with the attention tile body, narrowed to the
    attention family.  ``out`` ([B, H, Sq_out, hd] fp32, contiguous) is
    written in place: lockstep accumulates into it, free mode stores.

    CUDA tensors launch ``csrc/ws_attention.cu``; CPU tensors run the plain
    version.  There is no fallback between the two.  ``trace`` records the
    event rings, ``fault_plan`` injects a plan's launch faults (module
    docstring).
    """
    return _run(state, q, k, v, out, bq=bq, bk=bk, causal=causal, scale=scale,
                steal=steal, steal_policy=steal_policy, steal_run_cap=steal_run_cap,
                rounds=rounds, mult=mult, compress_runs=compress_runs, mode=mode,
                stage_open=stage_open, trace=trace, trace_capacity=trace_capacity,
                trace_remote=trace_remote, fault_plan=fault_plan,
                plain=q.device.type == "cpu")


def plain_ws_grid(state: QueueState, q, k, v, out, **kw) -> WSRunResult:
    """The plain PyTorch version of :func:`launch_ws_grid` on any device: the
    scheduler walk on the host, the tile math in torch on the tensors' device."""
    return _run(state, q, k, v, out, plain=True, **kw)


def run_ws_schedule(state: QueueState, q, k, v, *, causal: bool, bq: int, bk: int,
                    steal: bool = True, steal_policy: str = "cost",
                    steal_run_cap: int = 1, rounds: Optional[int] = None,
                    out=None, mult=None, compress_runs: Optional[bool] = None,
                    mode: Optional[str] = None, trace: bool = False,
                    trace_capacity: Optional[int] = None, fault_plan=None) -> WSRunResult:
    """Launch the attention megakernel over a prepared :class:`QueueState`.

    ``q``: [B, H, Sq, hd]; ``k``/``v``: [B, Hkv, Sk, hd], any strides (the
    kernel guards ``kpos < Sk`` and ``qpos < Sq`` itself, so nothing is
    padded or copied).  ``out``/``mult`` may be carried over from a previous
    launch (resume / multiplicity drills); ``out`` is [B, H, ceil(Sq/bq)·bq,
    hd] fp32.
    """
    B, H, Sq, hd = q.shape
    sq_out = -(-Sq // bq) * bq
    if out is None:
        out = torch.zeros((B, H, sq_out, hd), dtype=torch.float32, device=q.device)
    else:
        out = torch.as_tensor(out, dtype=torch.float32).to(q.device).clone().contiguous()
        if tuple(out.shape) != (B, H, sq_out, hd):
            raise ValueError(f"carried out has shape {tuple(out.shape)}, "
                             f"expected {(B, H, sq_out, hd)}")
    return launch_ws_grid(state, q, k, v, out, bq=bq, bk=bk, causal=causal,
                          scale=hd ** -0.5, steal=steal, steal_policy=steal_policy,
                          steal_run_cap=steal_run_cap, rounds=rounds, mult=mult,
                          compress_runs=compress_runs, mode=mode, trace=trace,
                          trace_capacity=trace_capacity, fault_plan=fault_plan)
