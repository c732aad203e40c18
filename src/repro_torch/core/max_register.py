"""MaxRegister and RangeMaxRegister objects (paper §3.1, §4.1; copy of
``repro/core/max_register.py``).

Three implementations:

* ``AtomicMaxRegister``  — a MaxRegister as a single atomic object (what
  Theorem 3.2 assumes).  Each MaxRead/MaxWrite is one atomic step; on the
  thread backend the GIL provides the atomicity, on the sim backend it is one
  scheduled step.  Constant step complexity but *not* derived from Read/Write.

* ``TreeMaxRegister``    — the fully Read/Write wait-free bounded MaxRegister
  of Aspnes–Attiya–Censor-Hillel [3] used by Theorem 3.3: a binary tree of
  atomic bits over capacity m.  MaxRead is a root-to-leaf descent (a sequence
  of reads); MaxWrite reads down the value's path and then sets the path's
  switch bits bottom-up (a sequence of reads followed by a sequence of
  writes).  Hence neither operation contains a Read-After-Write pattern and
  both run in O(log m) steps.

* ``RangeMaxRegister``   — Figure 6: one shared plain register R plus a
  per-process persistent local maximum r.  RMaxRead returns max(r, R.Read())
  — a value in the range [r, true max]; RMaxWrite publishes only fresh local
  maxima.  Fully Read/Write, fence-free, O(1), and sequentially-exact.
"""

from __future__ import annotations

from typing import Any, Dict

from .backend import ThreadBackend


class AtomicMaxRegister:
    def __init__(self, backend=None, init: int = 1):
        backend = backend if backend is not None else ThreadBackend()
        self._cell = backend.rmw_cell(init)

    def max_read(self, pid: int = 0) -> int:
        return self._cell.read(pid)

    def max_write(self, v: int, pid: int = 0) -> None:
        # One atomic step (cf. model): equivalent to a hardware atomic-max.
        self._cell.write_max(v, pid)


class TreeMaxRegister:
    """AACH Read/Write MaxRegister over values 0..capacity-1.

    The recursive structure MaxReg(m) = (switch bit, MaxReg(m/2) left for the
    low half, MaxReg(m/2) right for the high half) is flattened into a heap
    array of switch bits.  Leaves carry no state.

    MaxRead: descend from the root taking the right child whenever the switch
    is set; the leaf index reached is the maximum written so far.
    MaxWrite(v): walk v's root-to-leaf path; abandon if a switch already says
    the register holds something >= the high half v sits under; otherwise set
    the switch bits of v's path that should be 1, *bottom-up* (this order is
    what makes the algorithm linearizable, per the paper's Theorem 3.3
    discussion).  Reads all precede writes: no Read-After-Write pattern.
    """

    def __init__(self, capacity: int, backend=None):
        backend = backend if backend is not None else ThreadBackend()
        self.capacity = 1
        self.height = 0
        while self.capacity < capacity:
            self.capacity *= 2
            self.height += 1
        # Heap-indexed internal nodes: 1..capacity-1 (node i's children 2i, 2i+1).
        self.bits = backend.array(max(2 * self.capacity, 2), 0)

    def max_read(self, pid: int = 0) -> int:
        node, lo, span = 1, 0, self.capacity
        while span > 1:
            half = span // 2
            if self.bits.read(node, pid):
                node, lo, span = 2 * node + 1, lo + half, half
            else:
                node, lo, span = 2 * node, lo, half
        return lo

    def max_write(self, v: int, pid: int = 0) -> None:
        if not 0 <= v < self.capacity:
            raise ValueError(f"value {v} out of MaxRegister capacity {self.capacity}")
        # Phase 1 (reads): walk v's path; if at any node v lies in the LOW
        # half but the switch is already 1, the register already exceeds v.
        node, lo, span = 1, 0, self.capacity
        path_high = []  # nodes where v goes high -> their switch must be 1
        while span > 1:
            half = span // 2
            if v >= lo + half:
                path_high.append(node)
                node, lo, span = 2 * node + 1, lo + half, half
            else:
                if self.bits.read(node, pid):
                    return  # current max already >= lo + half > v
                node, lo, span = 2 * node, lo, half
        # Phase 2 (writes): set the high-path switches bottom-up.
        for node in reversed(path_high):
            self.bits.write(node, 1, pid)


class RangeMaxRegister:
    """Figure 6 algorithm.  ``r`` is process-local persistent state."""

    def __init__(self, backend=None, init: int = 1):
        backend = backend if backend is not None else ThreadBackend()
        self.R = backend.cell(init)
        self._r: Dict[int, int] = {}
        self._init = init

    def _local(self, pid: int) -> int:
        return self._r.get(pid, self._init)

    def rmax_write(self, x: int, pid: int = 0) -> bool:
        r = max(self._local(pid), self.R.read(pid))  # line 1
        if x > r:  # line 2
            self._r[pid] = x  # line 3 (local)
            self.R.write(x, pid)  # line 3 (shared) — any order
        else:
            self._r[pid] = r
        return True

    def rmax_read(self, pid: int = 0) -> int:
        r = max(self._local(pid), self.R.read(pid))  # line 6
        self._r[pid] = r
        return r
