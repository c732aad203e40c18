"""Host-side shim: the device queue layout driven through the
:mod:`repro_torch.core` API (copy of ``repro/pallas_ws/host.py``).

``PallasWSHost`` is WS-WMULT (paper Fig. 7) on the *exact* array layout the
megakernel uses (an indexed ``tasks`` array with ⊥ sentinels, a plain shared
``head`` register, per-process persistent local bounds, a ``taken``
announcement row and the advisory ``remaining``), built on
:mod:`repro_torch.core.backend` cells, so it runs under ``ThreadBackend``
(real threads) and ``SimBackend`` (deterministic adversarial interleavings)
like every other algorithm in ``repro_torch.core.ALGORITHMS`` (registered as
``"pallas-ws"``).

It lets the paper-level property checkers certify the device layout: the
slot arithmetic the kernel performs per claim is performed here one
shared-memory step at a time, where the simulator can split it.  It differs
from :class:`repro_torch.core.ws_wmult.WSWMult` only in representation:
0-based indexing (device arrays), a fixed capacity (device allocation), and
the announcement row (device diagnostics).
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.backend import BOTTOM, EMPTY, ThreadBackend
from repro_torch.pallas_ws.tasks import F_COST, TASK_WIDTH


def _cost_of(x: Any) -> int:
    """Tile-slot cost of a payload: encoded task records (TASK_WIDTH int
    sequences, see :mod:`repro_torch.pallas_ws.tasks`) carry it in ``F_COST``;
    opaque payloads count one slot."""
    try:
        if len(x) == TASK_WIDTH:
            return max(1, int(x[F_COST]))
    except (TypeError, ValueError):
        pass
    return 1


class PallasWSHost:
    """Fence-free Read/Write work-stealing on the pallas_ws array layout.

    Mirrors the device layout one field for one, including the §3.6
    advisory ``remaining`` cost summary the cost-aware victim selection
    ranks by: a plain Read/Write register, incremented by Put and
    decremented best-effort by successful Take/Steal (read, then write —
    deliberately *not* an RMW; concurrent updates may lose decrements, and
    the protocol never depends on the value): still zero RMW, zero locks
    on every path.
    """

    OWNER = 0

    def __init__(self, backend=None, capacity: int = 4096,
                 trace: bool = False, fault_plan=None, **_ignored: Any):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.capacity = capacity
        # chaos shim faults (repro_torch.chaos.FaultPlan): drop every n-th
        # advisory update (a lost plain write) and/or republish the
        # pre-claim head after every n-th claim (a §7 stale write racing
        # the claim).  Both are legal relaxed-memory behaviors the
        # protocol must absorb; counts land in ``faults_injected``.
        self.fault_plan = fault_plan
        self._advise_n = 0
        self._claim_n = 0
        self.faults_injected = {"dropped_advisories": 0,
                                "stale_republishes": 0}
        # Device mirror: tasks[s] (⊥-initialized suffix), head, taken row,
        # advisory remaining-cost summary.
        self.tasks = backend.array(capacity, init=BOTTOM)
        self.Head = backend.cell(0)
        self.taken = backend.map_cells(default=-1)  # (pid, slot) announcements
        self.remaining = backend.cell(0)  # advisory, plain R/W, stale-tolerant
        self.tail = 0  # owner-local, exactly as in Fig. 7
        self._local: Dict[int, int] = {}  # per-process persistent head bound
        # Host mirror of the device event rings (repro_torch.wstrace.ring): one
        # record per successful claim, appended *outside* the protocol's
        # shared-memory accesses.
        self.trace = trace
        self._events: list = []

    def _record(self, pid: int, slot: int, x: Any, kind: str) -> None:
        if not self.trace:
            return
        self._events.append({
            "pid": pid, "slot": slot, "kind": kind, "cost": _cost_of(x),
            "victim": self.OWNER if kind != "take" else -1,
        })

    def trace_events(self) -> list:
        """Claim-ordered host event log (``trace=True`` instances only)."""
        return list(self._events)

    def _local_head(self, pid: int) -> int:
        return self._local.get(pid, 0)

    def _advise(self, delta: int, pid: int) -> None:
        # best-effort advisory update: plain read + plain write (no CAS) —
        # a lost update mis-ranks victims, never changes extraction
        self._advise_n += 1
        fp = self.fault_plan
        if (fp is not None and fp.drop_advisory_every
                and self._advise_n % fp.drop_advisory_every == 0):
            self.faults_injected["dropped_advisories"] += 1
            return
        self.remaining.write(max(0, self.remaining.read(pid) + delta), pid)

    def _maybe_stale_republish(self, head: int, pid: int) -> None:
        # after a successful claim wrote head+1, resurface the pre-claim
        # value — exactly what a delayed plain write from a slower racer
        # could legally do; the claimed slot becomes stealable again and
        # the multiplicity bound (not prevention) must absorb it
        self._claim_n += 1
        fp = self.fault_plan
        if (fp is not None and fp.stale_head_every
                and self._claim_n % fp.stale_head_every == 0):
            self.Head.write(head, pid)
            self.faults_injected["stale_republishes"] += 1

    # -- owner ----------------------------------------------------------
    def put(self, x: Any, *, strict: bool = False) -> bool:
        """Owner Put of one task.  Returns ``False`` (no state touched) when
        the queue is full so callers can back off without catching;
        ``strict=True`` restores the raise for drill suites that treat a
        full queue as harness misconfiguration."""
        if self.tail + 1 >= self.capacity:
            if strict:
                raise RuntimeError(
                    f"pallas-ws queue full (capacity={self.capacity})"
                )
            return False
        pid = self.OWNER
        self.tasks.write(self.tail, x, pid)  # line 2 (task slot)
        if self.tail + 2 < self.capacity:
            # pre-clear invariant: the two slots past tail read as ⊥, never
            # uninitialized memory (already true at init; kept as the literal
            # Fig. 7 write, so the shared-access count stays faithful)
            self.tasks.write(self.tail + 2, BOTTOM, pid)
        self.tail += 1  # line 1 ordering is owner-local, no fence needed
        self._advise(_cost_of(x), pid)
        return True

    def put_segment(self, xs, *, strict: bool = False) -> bool:
        """Batched owner Put (amortized synchronization):
        append a whole segment of tasks with one record write per task, ONE
        pre-clear pair past the segment, one owner-local tail bump, and ONE
        advisory update for the segment's total cost — versus per-task
        pre-clears and advisories from looped :meth:`put`.  All-or-none:
        returns ``False`` (no state touched) unless the whole segment fits.
        Same Fig. 7 layout and same final state as the put loop; only the
        shared-access *count* shrinks, which is the point."""
        xs = list(xs)
        n = len(xs)
        if n == 0:
            return True
        if self.tail + n >= self.capacity:
            if strict:
                raise RuntimeError(
                    f"pallas-ws queue full (capacity={self.capacity}, "
                    f"segment={n})"
                )
            return False
        pid = self.OWNER
        for i, x in enumerate(xs):
            self.tasks.write(self.tail + i, x, pid)  # line 2, batched
        for c in (self.tail + n, self.tail + n + 1):
            # pre-clear invariant published once per segment, not per task
            if c < self.capacity:
                self.tasks.write(c, BOTTOM, pid)
        self.tail += n  # one owner-local bump for the whole segment
        self._advise(sum(_cost_of(x) for x in xs), pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        head = max(self._local_head(pid), self.Head.read(pid))  # RMaxRead
        if head < self.tail:  # line 5
            x = self.tasks.read(head, pid)  # line 6
            self.Head.write(head + 1, pid)  # plain write, read elided
            self._local[pid] = head + 1
            self.taken.write((pid, head), pid, pid)
            self._advise(-_cost_of(x), pid)
            self._record(pid, head, x, "take")
            self._maybe_stale_republish(head, pid)
            return x
        self._local[pid] = head
        return EMPTY

    # -- thieves ----------------------------------------------------------
    def steal(self, pid: int) -> Any:
        head = max(self._local_head(pid), self.Head.read(pid))  # line 11
        if head >= self.capacity:
            return EMPTY
        x = self.tasks.read(head, pid)  # line 12
        if x is not BOTTOM:  # line 13
            self.Head.write(head + 1, pid)  # line 14 — plain write
            self._local[pid] = head + 1  # line 15
            self.taken.write((pid, head), pid, pid)
            self._advise(-_cost_of(x), pid)
            self._record(pid, head, x, "steal")
            self._maybe_stale_republish(head, pid)
            return x
        self._local[pid] = head
        return EMPTY

    # -- diagnostics ------------------------------------------------------
    def remaining_estimate(self, pid: int = OWNER) -> int:
        """The advisory cost summary a §3.6 victim selection would rank by
        (possibly stale under concurrency — that is the point)."""
        return self.remaining.read(pid)

    def snapshot(self):
        """(head, tail, taken-announcements) for layout parity checks."""
        return (
            self.Head.read(self.OWNER),
            self.tail,
            dict(self.taken.m),
        )
