"""Bounded-multiplicity variants (paper §5; copy of ``repro/core/bounded.py``).

B-WS-MULT / B-WS-WMULT: an extra array ``A`` of booleans (init true) and a
single ``Swap`` instruction in Steal bound extraction of each task to at most
one Take *plus* one Steal.  Put and Take are unchanged (Put additionally
initializes A[tail] — the third write the paper blames for B-WS-WMULT's Put
slowdown); Steal claims A[head] with Swap(false) and only a successful claim
publishes head+1 and returns the task.  Steal becomes nonblocking rather than
wait-free.

On a failed claim the paper says the thief "increments head and goes back to
the read of Head".  For B-WS-WMULT the increment survives the retry through
the max(local, Head) refresh.  For B-WS-MULT a MaxRead would discard the local
increment, so we additionally *help* by MaxWriting head+1 before retrying —
without the help a thief could spin on a slot claimed by a crashed process,
which would break even nonblocking progress; the help is the standard fix and
does not change the set-linearization argument (the claim point is the Swap).

ExactWS (§5 "Removing multiplicity"): the same Swap-claim applied to Take as
well yields an *exact* FIFO work-stealing algorithm (every task extracted at
most once overall) at the price of RMW in both extraction operations.
"""

from __future__ import annotations

from typing import Any, Dict

from .backend import BOTTOM, EMPTY, ThreadBackend
from .max_register import AtomicMaxRegister, TreeMaxRegister
from .storage import make_store


class BWSMult:
    """B-WS-MULT: WS-MULT + Swap-claimed Steal."""

    OWNER = 0

    def __init__(self, backend=None, max_register: str = "tree",
                 capacity: int = 1 << 20, storage: str = "infinite", **store_kw: Any):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        if max_register == "tree":
            self.head_reg = TreeMaxRegister(capacity + 2, backend)
            self.head_reg.max_write(1, self.OWNER)
        else:
            self.head_reg = AtomicMaxRegister(backend, init=1)
        self.tasks = make_store(storage, backend, **store_kw)
        self.tasks.write(1, BOTTOM, self.OWNER)
        self.tasks.write(2, BOTTOM, self.OWNER)
        self.claims = backend.rmw_map_cells(default=True)  # array A, init true
        self.tail = 0

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        self.tail += 1
        # §8.3's "third write" (re-arming A[tail]) must precede the task
        # write: a thief only swaps A[i] after reading a non-⊥ task from
        # Tasks[i], so ordering the re-arm before the task publish makes the
        # reset invisible to any claimer of this slot.  (The formal §5 spec
        # has A pre-initialized and Put unchanged; we keep the write for
        # benchmark fidelity with the paper's measured 3-write Put.)
        self.claims.write(self.tail, True, pid)
        self.tasks.write(self.tail, x, pid)
        self.tasks.write(self.tail + 2, BOTTOM, pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        head = self.head_reg.max_read(pid)
        if head <= self.tail:
            x = self.tasks.read(head, pid)
            self.head_reg.max_write(head + 1, pid)
            return x
        return EMPTY

    def steal(self, pid: int) -> Any:
        while True:
            head = self.head_reg.max_read(pid)  # line 10
            x = self.tasks.read(head, pid)  # line 11
            if x is BOTTOM:
                return EMPTY
            if self.claims.swap(head, False, pid):  # claim via single Swap
                self.head_reg.max_write(head + 1, pid)  # line 13
                return x  # line 14
            # lost the claim: help advance Head, then start over (see module doc)
            self.head_reg.max_write(head + 1, pid)


class BWSWMult:
    """B-WS-WMULT: WS-WMULT + Swap-claimed Steal (the paper's benchmarked variant)."""

    OWNER = 0

    def __init__(self, backend=None, storage: str = "infinite", **store_kw: Any):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.Head = backend.cell(1)
        self.tasks = make_store(storage, backend, **store_kw)
        self.tasks.write(1, BOTTOM, self.OWNER)
        self.tasks.write(2, BOTTOM, self.OWNER)
        self.claims = backend.rmw_map_cells(default=True)
        self.tail = 0
        self._head: Dict[int, int] = {}

    def _local_head(self, pid: int) -> int:
        return self._head.get(pid, 1)

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        self.tail += 1
        self.claims.write(self.tail, True, pid)  # re-arm BEFORE publish (see BWSMult.put)
        self.tasks.write(self.tail, x, pid)
        self.tasks.write(self.tail + 2, BOTTOM, pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        head = max(self._local_head(pid), self.Head.read(pid))
        if head <= self.tail:
            x = self.tasks.read(head, pid)
            self.Head.write(head + 1, pid)
            self._head[pid] = head + 1
            return x
        self._head[pid] = head
        return EMPTY

    def steal(self, pid: int) -> Any:
        while True:
            head = max(self._local_head(pid), self.Head.read(pid))
            x = self.tasks.read(head, pid)
            if x is BOTTOM:
                self._head[pid] = head
                return EMPTY
            if self.claims.swap(head, False, pid):
                self.Head.write(head + 1, pid)
                self._head[pid] = head + 1
                return x
            # lost the claim: local increment survives the retry via max()
            self._head[pid] = head + 1


class ExactWS:
    """§5 'Removing multiplicity': Swap-claims in both Take and Steal.

    Exactly-once extraction (useful as the ground-truth oracle in tests and as
    the exact-WS baseline in the scheduler benchmarks).
    """

    OWNER = 0

    def __init__(self, backend=None, storage: str = "infinite", **store_kw: Any):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.head_reg = AtomicMaxRegister(backend, init=1)
        self.tasks = make_store(storage, backend, **store_kw)
        self.tasks.write(1, BOTTOM, self.OWNER)
        self.tasks.write(2, BOTTOM, self.OWNER)
        self.claims = backend.rmw_map_cells(default=True)
        self.tail = 0

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        self.tail += 1
        self.claims.write(self.tail, True, pid)  # re-arm BEFORE publish (see BWSMult.put)
        self.tasks.write(self.tail, x, pid)
        self.tasks.write(self.tail + 2, BOTTOM, pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        while True:
            head = self.head_reg.max_read(pid)
            if head > self.tail:
                return EMPTY
            if self.claims.swap(head, False, pid):
                x = self.tasks.read(head, pid)
                self.head_reg.max_write(head + 1, pid)
                return x
            self.head_reg.max_write(head + 1, pid)

    def steal(self, pid: int) -> Any:
        while True:
            head = self.head_reg.max_read(pid)
            x = self.tasks.read(head, pid)
            if x is BOTTOM:
                return EMPTY
            if self.claims.swap(head, False, pid):
                self.head_reg.max_write(head + 1, pid)
                return x
            self.head_reg.max_write(head + 1, pid)
