"""Baseline work-stealing algorithms the paper compares against (§8; copy of
``repro/core/baselines.py``).

* ChaseLev        — dynamic circular work-stealing deque [11].  Owner LIFO,
                    thieves FIFO; CAS on ``top`` in Steal and in Take's
                    last-element race; a store-load fence in Take (no-op here,
                    see backend docstring).
* TheCilk         — THE protocol of Cilk-5 [14]: Take is Read/Write on the
                    fast path with a lock on the near-empty slow path; Steal
                    is serialized by the lock.
* IdempotentFIFO  — Michael-Vechev-Saraswat idempotent FIFO queue [24]
                    (paper Figure 8), including ``expand``.
* IdempotentLIFO  — idempotent LIFO stack [24]: single (tail, tag) anchor,
                    CAS'd by thieves.
* IdempotentDeque — idempotent double-ended extraction [24]: (head, size, tag)
                    anchor; owner puts/takes at one end, thieves steal at the
                    other.

All use growable arrays; the idempotent ones follow their papers' expand
(copy into a double-size array, republish the array reference).  They serve as the
exact and idempotent baselines of the ``ALGORITHMS`` registry and as the §7
separation witness (a task extracted an unbounded number of times by *non-concurrent*
steals — impossible for WS-MULT/WS-WMULT).
"""

from __future__ import annotations

from typing import Any

from .backend import EMPTY, ThreadBackend


class _Buf:
    """Plain object array with a size attribute (snapshot-published)."""

    __slots__ = ("a", "size")

    def __init__(self, size: int):
        self.size = size
        self.a = [None] * size


class ChaseLev:
    OWNER = 0

    def __init__(self, backend=None, initial_len: int = 256):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.top = backend.rmw_cell(0)  # steal end
        self.bottom = backend.cell(0)  # owner end
        self.buf_ref = backend.cell(_Buf(initial_len))

    def _grow(self, b: int, t: int, pid: int) -> None:
        old = self.buf_ref.read(pid)
        new = _Buf(old.size * 2)
        for i in range(t, b):
            new.a[i % new.size] = old.a[i % old.size]
        self.buf_ref.write(new, pid)

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        b = self.bottom.read(pid)
        t = self.top.read(pid)
        buf = self.buf_ref.read(pid)
        if b - t >= buf.size - 1:
            self._grow(b, t, pid)
            buf = self.buf_ref.read(pid)
        buf.a[b % buf.size] = x
        self.backend.fence()  # store-store
        self.bottom.write(b + 1, pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        b = self.bottom.read(pid) - 1
        buf = self.buf_ref.read(pid)
        self.bottom.write(b, pid)
        self.backend.fence()  # store-load fence — the expensive one
        t = self.top.read(pid)
        if b < t:  # empty
            self.bottom.write(t, pid)
            return EMPTY
        x = buf.a[b % buf.size]
        if b > t:
            return x
        # last element: race with thieves via CAS
        if not self.top.cas(t, t + 1, pid):
            x = EMPTY
        self.bottom.write(t + 1, pid)
        return x

    def steal(self, pid: int) -> Any:
        while True:
            t = self.top.read(pid)
            self.backend.fence()  # load-load
            b = self.bottom.read(pid)
            if t >= b:
                return EMPTY
            buf = self.buf_ref.read(pid)
            x = buf.a[t % buf.size]
            if self.top.cas(t, t + 1, pid):
                return x
            # lost the race: retry (nonblocking)


class TheCilk:
    """THE protocol (T = tail/owner end, H = head/steal end, lock E)."""

    OWNER = 0

    def __init__(self, backend=None, initial_len: int = 256):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.T = backend.cell(0)
        self.H = backend.cell(0)
        self.lock = backend.lock()
        self.buf_ref = backend.cell(_Buf(initial_len))

    def _grow(self, h: int, t: int, pid: int) -> None:
        old = self.buf_ref.read(pid)
        new = _Buf(old.size * 2)
        for i in range(h, t):
            new.a[i % new.size] = old.a[i % old.size]
        self.buf_ref.write(new, pid)

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        t = self.T.read(pid)
        h = self.H.read(pid)
        buf = self.buf_ref.read(pid)
        if t - h >= buf.size - 1:
            with self.lock:  # growth serialized against thieves
                self._grow(self.H.read(pid), t, pid)
            buf = self.buf_ref.read(pid)
        buf.a[t % buf.size] = x
        self.backend.fence()
        self.T.write(t + 1, pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        t = self.T.read(pid) - 1
        buf = self.buf_ref.read(pid)
        self.T.write(t, pid)
        self.backend.fence()  # store-load
        h = self.H.read(pid)
        # Steal reads H and T and publishes H + 1 only after its check, so a
        # thief may hold index h == t unpublished: the fast path takes only
        # h < t, and the last task goes through the lock.  (``repro``'s copy
        # takes h <= t here and can return the last task to both.)
        if h < t:
            return buf.a[t % buf.size]
        # potential conflict: restore and retry under the lock
        self.T.write(t + 1, pid)
        with self.lock:
            t = self.T.read(pid) - 1
            self.T.write(t, pid)
            h = self.H.read(pid)
            if h <= t:
                return buf.a[t % buf.size]
            self.T.write(h, pid)  # deque empty: reset
            return EMPTY

    def steal(self, pid: int) -> Any:
        with self.lock:
            h = self.H.read(pid)
            self.backend.fence()
            t = self.T.read(pid)
            if h >= t:
                return EMPTY
            buf = self.buf_ref.read(pid)
            x = buf.a[h % buf.size]
            self.H.write(h + 1, pid)
            return x


class IdempotentFIFO:
    """Paper Figure 8 (Michael et al. [24]), faithful including expand."""

    OWNER = 0

    def __init__(self, backend=None, initial_len: int = 256):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.head = backend.rmw_cell(0)
        self.tail = backend.cell(0)
        self.tasks_ref = backend.cell(_Buf(initial_len))

    def _expand(self, pid: int) -> None:
        old = self.tasks_ref.read(pid)
        h = self.head.read(pid)
        t = self.tail.read(pid)
        new = _Buf(old.size * 2)
        for i in range(h, t):
            new.a[i % new.size] = old.a[i % old.size]
        self.backend.fence()  # order copies before publishing the array
        self.tasks_ref.write(new, pid)
        self.backend.fence()  # order publish before the put's tail write

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        while True:
            h = self.head.read(pid)  # line 1
            t = self.tail.read(pid)  # line 2
            tasks = self.tasks_ref.read(pid)
            if t == h + tasks.size:  # line 3
                self._expand(pid)
                continue
            tasks.a[t % tasks.size] = x  # line 4
            self.backend.fence()  # order write at 4 before write at 5
            self.tail.write(t + 1, pid)  # line 5
            return True

    def take(self) -> Any:
        pid = self.OWNER
        h = self.head.read(pid)  # line 1
        t = self.tail.read(pid)  # line 2
        if h == t:  # line 3
            return EMPTY
        tasks = self.tasks_ref.read(pid)
        x = tasks.a[h % tasks.size]  # line 4
        self.head.write(h + 1, pid)  # line 5
        return x

    def steal(self, pid: int) -> Any:
        while True:
            h = self.head.read(pid)  # line 1
            self.backend.fence()  # order read 1 before read 2
            t = self.tail.read(pid)  # line 2
            if h == t:  # line 3
                return EMPTY
            self.backend.fence()  # order read 1 before read 4
            a = self.tasks_ref.read(pid)  # line 4
            x = a.a[h % a.size]  # line 5
            self.backend.fence()  # order read 5 before CAS 6
            if self.head.cas(h, h + 1, pid):  # line 6
                return x


class IdempotentLIFO:
    """Idempotent LIFO [24]: single-word (tail, tag) anchor."""

    OWNER = 0

    def __init__(self, backend=None, initial_len: int = 256):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.anchor = backend.rmw_cell((0, 0))  # (tail, tag)
        self.tasks_ref = backend.cell(_Buf(initial_len))

    def _expand(self, t: int, pid: int) -> None:
        old = self.tasks_ref.read(pid)
        new = _Buf(old.size * 2)
        for i in range(t):
            new.a[i] = old.a[i]
        self.backend.fence()
        self.tasks_ref.write(new, pid)

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        t, g = self.anchor.read(pid)
        tasks = self.tasks_ref.read(pid)
        if t == tasks.size:
            self._expand(t, pid)
            tasks = self.tasks_ref.read(pid)
        tasks.a[t] = x
        self.backend.fence()  # order task write before anchor publish
        self.anchor.write((t + 1, g + 1), pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        t, g = self.anchor.read(pid)
        if t == 0:
            return EMPTY
        tasks = self.tasks_ref.read(pid)
        x = tasks.a[t - 1]
        self.anchor.write((t - 1, g), pid)
        return x

    def steal(self, pid: int) -> Any:
        while True:
            t, g = self.anchor.read(pid)
            if t == 0:
                return EMPTY
            self.backend.fence()
            tasks = self.tasks_ref.read(pid)
            x = tasks.a[t - 1]
            if self.anchor.cas((t, g), (t - 1, g), pid):
                return x


class IdempotentDeque:
    """Idempotent double-ended extraction [24]: (head, size, tag) anchor.

    Owner puts at the tail and takes from the tail; thieves steal from the
    head — the 'deque' insert/extract order of [24].
    """

    OWNER = 0

    def __init__(self, backend=None, initial_len: int = 256):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        self.anchor = backend.rmw_cell((0, 0, 0))  # (head, size, tag)
        self.tasks_ref = backend.cell(_Buf(initial_len))

    def _expand(self, h: int, sz: int, pid: int) -> None:
        old = self.tasks_ref.read(pid)
        new = _Buf(old.size * 2)
        for i in range(h, h + sz):
            new.a[i % new.size] = old.a[i % old.size]
        self.backend.fence()
        self.tasks_ref.write(new, pid)

    def put(self, x: Any) -> bool:
        pid = self.OWNER
        h, sz, g = self.anchor.read(pid)
        tasks = self.tasks_ref.read(pid)
        if sz == tasks.size:
            self._expand(h, sz, pid)
            tasks = self.tasks_ref.read(pid)
        tasks.a[(h + sz) % tasks.size] = x
        self.backend.fence()
        self.anchor.write((h, sz + 1, g + 1), pid)
        return True

    def take(self) -> Any:
        pid = self.OWNER
        h, sz, g = self.anchor.read(pid)
        if sz == 0:
            return EMPTY
        tasks = self.tasks_ref.read(pid)
        x = tasks.a[(h + sz - 1) % tasks.size]
        self.anchor.write((h, sz - 1, g), pid)
        return x

    def steal(self, pid: int) -> Any:
        while True:
            h, sz, g = self.anchor.read(pid)
            if sz == 0:
                return EMPTY
            self.backend.fence()
            tasks = self.tasks_ref.read(pid)
            x = tasks.a[h % tasks.size]
            if self.anchor.cas((h, sz, g), ((h + 1) % tasks.size, sz - 1, g), pid):
                return x
