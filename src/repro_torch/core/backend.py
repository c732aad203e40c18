"""Shared-memory cells for the host-side WS-WMULT queues (the ThreadBackend
half of ``repro/core/backend.py``).

Under CPython's GIL an aligned object-slot read or write is atomic, the
analogue of an aligned word access in the paper's model, so plain attribute
and list accesses are the Read/Write registers.  The algorithms here are
fence-free by construction, so the backend offers no fence.
"""

from __future__ import annotations

from typing import Any, Optional


class Empty:
    """Sentinel returned by Take/Steal on an empty queue."""

    _instance: Optional["Empty"] = None

    def __new__(cls) -> "Empty":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "EMPTY"


class Bottom:
    """The paper's ⊥ value marking a not-yet-filled task slot."""

    _instance: Optional["Bottom"] = None

    def __new__(cls) -> "Bottom":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "⊥"


class Uninit:
    """Distinguished value for memory the owner never initialised."""

    _instance: Optional["Uninit"] = None

    def __new__(cls) -> "Uninit":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "UNINIT"


EMPTY = Empty()
BOTTOM = Bottom()
UNINIT = Uninit()


class Cell:
    """An atomic Read/Write register."""

    __slots__ = ("v",)

    def __init__(self, v: Any = None):
        self.v = v

    def read(self, pid: int = 0) -> Any:
        return self.v

    def write(self, v: Any, pid: int = 0) -> None:
        self.v = v


class ArrayCells:
    """A fixed-length array of atomic Read/Write registers."""

    __slots__ = ("a", "size")

    def __init__(self, size: int, init: Any = None):
        self.size = size
        self.a = [init] * size

    def read(self, i: int, pid: int = 0) -> Any:
        return self.a[i]

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        self.a[i] = v


class MapCells:
    """An unbounded array of Read/Write registers; a missing key reads as
    ``default`` (UNINIT, so reads of never-written memory show)."""

    __slots__ = ("m", "default")

    def __init__(self, default: Any = UNINIT):
        self.m = {}
        self.default = default

    def read(self, i: int, pid: int = 0) -> Any:
        return self.m.get(i, self.default)

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        self.m[i] = v


class ThreadBackend:
    """Raw shared memory for real threads."""

    name = "thread"

    def cell(self, init: Any = None) -> Cell:
        return Cell(init)

    def array(self, size: int, init: Any = None) -> ArrayCells:
        return ArrayCells(size, init)

    def map_cells(self, default: Any = UNINIT) -> MapCells:
        return MapCells(default)
