"""Task-array storage schemes (paper §6; copy of ``repro/core/storage.py``).

Queues address ``Tasks`` with absolute, monotonically increasing 1-based
indices; every slot is written at most a couple of times by the owner, and
never wraps, so the three schemes are interchangeable:

* :class:`InfiniteStore` — the idealised infinite array (missing entries
  read as UNINIT, so reads of never-written memory show);
* :class:`GrowableStore` — §6 approach (1): a finite array the owner copies
  into one of double size when full (Put wait-free, unbounded steps);
* :class:`LinkedStore` — §6 approach (2): a list of fixed-size node arrays
  (Put wait-free in O(1) steps).

Only the owner calls :meth:`write`; owner and thieves call :meth:`read`.
"""

from __future__ import annotations

from typing import Any

from .backend import UNINIT, ThreadBackend


class InfiniteStore:
    """The idealised infinite array of the paper's analysis (dict-backed)."""

    def __init__(self, backend, default: Any = UNINIT):
        self.cells = backend.map_cells(default)

    def read(self, i: int, pid: int = 0) -> Any:
        return self.cells.read(i, pid)

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        self.cells.write(i, v, pid)


class GrowableStore:
    """Copy-double finite array (§6 approach 1), 1-based absolute indices.
    The array reference is itself a shared register: the owner swings it
    after copying, thieves read it once; a thief on a stale array is safe
    because slots are write-once and copied verbatim."""

    def __init__(self, backend, initial_len: int = 256, default: Any = UNINIT):
        self.backend = backend
        self.default = default
        self.ref = backend.cell(backend.array(initial_len, default))

    def read(self, i: int, pid: int = 0) -> Any:
        arr = self.ref.read(pid)
        if i - 1 >= arr.size:
            # a thief ahead of an expansion it has not seen: the newest array
            # has nothing there yet either
            return self.default
        return arr.read(i - 1, pid)

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        arr = self.ref.read(pid)
        if i - 1 >= arr.size:
            new_len = arr.size
            while i - 1 >= new_len:
                new_len *= 2
            new = self.backend.array(new_len, self.default)
            for j in range(arr.size):  # owner-only copy
                new.write(j, arr.read(j, pid), pid)
            self.ref.write(new, pid)
            arr = new
        arr.write(i - 1, v, pid)


class LinkedStore:
    """Linked list of fixed-size node arrays (§6 approach 2): index i lives at
    node (i-1)//node_len, offset (i-1)%node_len; the owner links a fresh
    node in O(1) steps when the current one fills."""

    def __init__(self, backend, node_len: int = 256, default: Any = UNINIT):
        self.backend = backend
        self.node_len = node_len
        self.default = default
        self.node_table = backend.map_cells(default=None)
        self.node_table.write(0, backend.array(node_len, default))

    def read(self, i: int, pid: int = 0) -> Any:
        node = self.node_table.read((i - 1) // self.node_len, pid)
        if node is None:
            return self.default  # thief ahead of the owner's link step
        return node.read((i - 1) % self.node_len, pid)

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        k = (i - 1) // self.node_len
        node = self.node_table.read(k, pid)
        if node is None:
            node = self.backend.array(self.node_len, self.default)
            self.node_table.write(k, node, pid)
        node.write((i - 1) % self.node_len, v, pid)


def make_store(kind: str, backend=None, **kw):
    backend = backend if backend is not None else ThreadBackend()
    if kind == "infinite":
        return InfiniteStore(backend, **kw)
    if kind == "growable":
        return GrowableStore(backend, **kw)
    if kind == "linked":
        return LinkedStore(backend, **kw)
    raise ValueError(f"unknown store kind: {kind!r}")
