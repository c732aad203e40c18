"""WS-WMULT (paper Figure 7): fully Read/Write, fence-free work-stealing with
weak multiplicity, RangeMaxRegister inlined (copy of ``repro/core/ws_wmult.py``).

``Head`` is a plain Read/Write register; each process keeps a persistent
local lower bound on it.  Take/Steal refresh the bound with
max(local, Head.Read()) and on success plainly write head+1.  A slow process
may drag ``Head`` backwards — another process can then re-extract a task —
but each local bound only grows, so no process extracts a task twice.
"""

from __future__ import annotations

from typing import Any, Dict

from .backend import BOTTOM, EMPTY, ThreadBackend
from .storage import make_store


class WSWMult:
    OWNER = 0

    def __init__(self, backend=None, storage: str = "infinite",
                 put_order: str = "task_first", **store_kw: Any):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.Head = backend.cell(1)  # shared plain register, init 1
        self.tasks = make_store(storage, backend, **store_kw)
        self.tasks.write(1, BOTTOM, self.OWNER)
        self.tasks.write(2, BOTTOM, self.OWNER)
        self.tail = 0  # owner-local
        self._head: Dict[int, int] = {}  # per-process persistent local head
        self.put_order = put_order

    def _local_head(self, pid: int) -> int:
        return self._head.get(pid, 1)

    # -- owner ----------------------------------------------------------
    def put(self, x: Any) -> bool:
        pid = self.OWNER
        self.tail += 1  # line 1
        if self.put_order == "task_first":  # line 2 (either order)
            self.tasks.write(self.tail, x, pid)
            self.tasks.write(self.tail + 2, BOTTOM, pid)
        else:
            self.tasks.write(self.tail + 2, BOTTOM, pid)
            self.tasks.write(self.tail, x, pid)
        return True  # line 3

    def take(self) -> Any:
        pid = self.OWNER
        head = max(self._local_head(pid), self.Head.read(pid))  # line 4
        if head <= self.tail:  # line 5
            x = self.tasks.read(head, pid)  # line 6
            self.Head.write(head + 1, pid)
            self._head[pid] = head + 1  # line 7
            return x  # line 8
        self._head[pid] = head
        return EMPTY  # line 10

    # -- thieves ----------------------------------------------------------
    def steal(self, pid: int) -> Any:
        head = max(self._local_head(pid), self.Head.read(pid))  # line 11
        x = self.tasks.read(head, pid)  # line 12
        if x is not BOTTOM:  # line 13
            self.Head.write(head + 1, pid)  # line 14
            self._head[pid] = head + 1  # line 15
            return x  # line 16
        self._head[pid] = head
        return EMPTY  # line 18
