"""Shared-memory cells for the host-side work-stealing algorithms (copy of
``repro/core/backend.py``).

Every algorithm is coded once against a small cell/array API and runs on
two interchangeable backends:

* :class:`ThreadBackend` — plain attribute and list accesses.  Under
  CPython's GIL an aligned object-slot read or write is atomic, the
  analogue of an aligned word access in the paper's model, so they are the
  Read/Write registers.  RMW cells (CAS, Swap, Fetch&Add, for the
  baselines and the bounded variants) take a per-cell mutex.
* :class:`SimBackend` — every shared access is a step granted by a
  deterministic :class:`SimController`, so a schedule (a sequence of
  process ids) fixes the interleaving and the timestamps that the property
  checkers of :mod:`.simulator` read.  Local variables are free, as in the
  paper's step counts.

``fence()`` is a no-op on both: the paper's algorithms are fence-free, and
the baselines that need ordering get it from the GIL's sequential
consistency; the call sites mark where a real implementation needs one.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence


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


class RMWCell(Cell):
    """A register additionally supporting CAS / Swap / Fetch&Add."""

    __slots__ = ("_lock",)

    def __init__(self, v: Any = None):
        super().__init__(v)
        self._lock = threading.Lock()

    def cas(self, expect: Any, new: Any, pid: int = 0) -> bool:
        with self._lock:
            if self.v == expect:
                self.v = new
                return True
            return False

    def swap(self, new: Any, pid: int = 0) -> Any:
        with self._lock:
            old = self.v
            self.v = new
            return old

    def fetch_add(self, delta: int = 1, pid: int = 0) -> Any:
        with self._lock:
            old = self.v
            self.v = old + delta
            return old

    def write_max(self, v: Any, pid: int = 0) -> None:
        """Atomic max (a single RMW step) — backs AtomicMaxRegister."""
        with self._lock:
            if v > self.v:
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


class RMWMapCells(MapCells):
    """Unbounded array of RMW registers (used by the bounded B-WS-* variants)."""

    __slots__ = ("_lock",)

    def __init__(self, default: Any = UNINIT):
        super().__init__(default)
        self._lock = threading.Lock()

    def swap(self, i: int, v: Any, pid: int = 0) -> Any:
        with self._lock:
            old = self.m.get(i, self.default)
            self.m[i] = v
            return old

    def cas(self, i: int, expect: Any, new: Any, pid: int = 0) -> bool:
        with self._lock:
            if self.m.get(i, self.default) == expect:
                self.m[i] = new
                return True
            return False


class ThreadBackend:
    """Raw shared memory for real threads."""

    name = "thread"

    def cell(self, init: Any = None) -> Cell:
        return Cell(init)

    def rmw_cell(self, init: Any = None) -> RMWCell:
        return RMWCell(init)

    def array(self, size: int, init: Any = None) -> ArrayCells:
        return ArrayCells(size, init)

    def map_cells(self, default: Any = UNINIT) -> MapCells:
        return MapCells(default)

    def rmw_map_cells(self, default: Any = UNINIT) -> RMWMapCells:
        return RMWMapCells(default)

    def lock(self) -> threading.Lock:
        return threading.Lock()

    def fence(self) -> None:  # documented no-op, see the module docstring
        pass


# ---------------------------------------------------------------------------
# Deterministic-interleaving simulator backend.
# ---------------------------------------------------------------------------


class SimController:
    """Serializes shared-memory steps of concurrently running operations.

    Each process's operation sequence runs in its own thread; every shared
    access first *arrives* at the gate, then the controller grants exactly one
    arrived process a step according to ``schedule`` (a sequence of process
    ids; unmatched/done entries fall through round-robin).  Because a thread
    only proceeds when granted, and performs exactly one access per grant,
    shared accesses are totally ordered and reproducible.

    The controller also timestamps operation invocations/responses with the
    global step counter so tests can decide operation concurrency (the
    ``op || op'`` relation of §2) — this is what the set-linearizability
    property checks are built on.
    """

    def __init__(self, schedule: Optional[Sequence[int]] = None):
        self.schedule = list(schedule) if schedule is not None else []
        self.cv = threading.Condition()
        self.state: Dict[int, str] = {}
        self.granted: Optional[int] = None
        self.step_no = 0
        self.trace: List[int] = []
        self.active = False  # gates are open until run() starts (setup phase)

    # -- called from worker threads --------------------------------------
    def gate(self, pid: int) -> None:
        if not self.active:
            return  # queue construction / post-run inspection is free
        with self.cv:
            self.state[pid] = "at_gate"
            self.cv.notify_all()
            while self.granted != pid:
                self.cv.wait()
            self.granted = None
            self.state[pid] = "running"

    def now(self) -> int:
        return self.step_no

    def _finish(self, pid: int) -> None:
        with self.cv:
            self.state[pid] = "done"
            self.cv.notify_all()

    # -- controller loop ---------------------------------------------------
    def run(self, procs: Dict[int, Callable[[], None]], timeout: float = 60.0) -> None:
        """Run the per-process callables to completion under the schedule."""
        self.active = True
        threads = {}
        for pid, fn in procs.items():
            self.state[pid] = "running"

            def wrapper(pid=pid, fn=fn):
                try:
                    fn()
                finally:
                    self._finish(pid)

            t = threading.Thread(target=wrapper, daemon=True)
            threads[pid] = t
        for t in threads.values():
            t.start()

        sched_i = 0
        while True:
            with self.cv:
                # a grant counts once the granted process has taken it: until
                # then it still reads "at_gate", and deciding again would
                # overwrite the grant (a step lost, the interleaving no longer
                # the schedule's)
                while self.granted is not None or any(
                        s == "running" for s in self.state.values()):
                    if not self.cv.wait(timeout):  # hang guard
                        raise RuntimeError("simulator stalled (deadlock in algorithm?)")
                waiting = [p for p, s in self.state.items() if s == "at_gate"]
                if not waiting:
                    break  # everyone done
                pick = None
                while sched_i < len(self.schedule):
                    cand = self.schedule[sched_i]
                    sched_i += 1
                    if cand in self.state and self.state[cand] == "at_gate":
                        pick = cand
                        break
                if pick is None:  # schedule exhausted -> round-robin fallback
                    pick = waiting[self.step_no % len(waiting)]
                self.granted = pick
                self.step_no += 1
                self.trace.append(pick)
                self.cv.notify_all()
        for t in threads.values():
            t.join(timeout)
        self.active = False


class SimCell:
    __slots__ = ("v", "ctrl")

    def __init__(self, ctrl: SimController, v: Any = None):
        self.ctrl = ctrl
        self.v = v

    def read(self, pid: int = 0) -> Any:
        self.ctrl.gate(pid)
        return self.v

    def write(self, v: Any, pid: int = 0) -> None:
        self.ctrl.gate(pid)
        self.v = v


class SimRMWCell(SimCell):
    __slots__ = ()

    def cas(self, expect: Any, new: Any, pid: int = 0) -> bool:
        self.ctrl.gate(pid)
        if self.v == expect:
            self.v = new
            return True
        return False

    def swap(self, new: Any, pid: int = 0) -> Any:
        self.ctrl.gate(pid)
        old = self.v
        self.v = new
        return old

    def fetch_add(self, delta: int = 1, pid: int = 0) -> Any:
        self.ctrl.gate(pid)
        old = self.v
        self.v = old + delta
        return old

    def write_max(self, v: Any, pid: int = 0) -> None:
        self.ctrl.gate(pid)
        if v > self.v:
            self.v = v


class SimArrayCells:
    __slots__ = ("a", "size", "ctrl")

    def __init__(self, ctrl: SimController, size: int, init: Any = None):
        self.ctrl = ctrl
        self.size = size
        self.a = [init] * size

    def read(self, i: int, pid: int = 0) -> Any:
        self.ctrl.gate(pid)
        return self.a[i]

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        self.ctrl.gate(pid)
        self.a[i] = v


class SimMapCells:
    __slots__ = ("m", "default", "ctrl")

    def __init__(self, ctrl: SimController, default: Any = UNINIT):
        self.ctrl = ctrl
        self.m = {}
        self.default = default

    def read(self, i: int, pid: int = 0) -> Any:
        self.ctrl.gate(pid)
        return self.m.get(i, self.default)

    def write(self, i: int, v: Any, pid: int = 0) -> None:
        self.ctrl.gate(pid)
        self.m[i] = v


class SimRMWMapCells(SimMapCells):
    __slots__ = ()

    def swap(self, i: int, v: Any, pid: int = 0) -> Any:
        self.ctrl.gate(pid)
        old = self.m.get(i, self.default)
        self.m[i] = v
        return old

    def cas(self, i: int, expect: Any, new: Any, pid: int = 0) -> bool:
        self.ctrl.gate(pid)
        if self.m.get(i, self.default) == expect:
            self.m[i] = new
            return True
        return False


class _SimLock:
    """A lock whose acquire/release are shared-memory steps (for THE Cilk)."""

    def __init__(self, ctrl: SimController):
        self.ctrl = ctrl
        self._lock = threading.Lock()

    def __enter__(self):
        # Model acquire as a step; the underlying mutex keeps real threads
        # honest if the schedule interleaves inside a critical section.
        self.ctrl.gate(getattr(_tls, "pid", 0))
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


_tls = threading.local()


def set_sim_pid(pid: int) -> None:
    """Declare the calling thread's process id (used by _SimLock gating)."""
    _tls.pid = pid


class SimBackend:
    """Shared memory whose every access is a controller-scheduled step."""

    name = "sim"

    def __init__(self, ctrl: SimController):
        self.ctrl = ctrl

    def cell(self, init: Any = None) -> SimCell:
        return SimCell(self.ctrl, init)

    def rmw_cell(self, init: Any = None) -> SimRMWCell:
        return SimRMWCell(self.ctrl, init)

    def array(self, size: int, init: Any = None) -> SimArrayCells:
        return SimArrayCells(self.ctrl, size, init)

    def map_cells(self, default: Any = UNINIT) -> SimMapCells:
        return SimMapCells(self.ctrl, default)

    def rmw_map_cells(self, default: Any = UNINIT) -> SimRMWMapCells:
        return SimRMWMapCells(self.ctrl, default)

    def lock(self) -> _SimLock:
        return _SimLock(self.ctrl)

    def fence(self) -> None:
        pass
