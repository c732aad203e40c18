"""WS-MULT (paper Figure 3): work-stealing with multiplicity from a MaxRegister
(copy of ``repro/core/ws_mult.py``).

The queue's head is synchronized by a single MaxRegister ``Head``; the tail is
the owner's local persistent variable.  Every operation is wait-free; Put is
fully Read/Write and O(1); with the AACH tree MaxRegister (Theorem 3.3) the
whole object is fully Read/Write with O(log m) Take/Steal and no
Read-After-Write pattern in any operation.

Faithfulness notes:
* ``Tasks`` is 1-based, slots 1 and 2 pre-initialized to ⊥, and each Put(x)
  performs {Tasks[tail].Write(x), Tasks[tail+2].Write(⊥)} — the brace notation
  means the two writes may run in either order (fence-free); we expose
  ``put_order`` so the interleaving tests can exercise both orders.
* Take reads Tasks[head] and MaxWrites head+1 in either order (line 6 braces);
  likewise exposed for tests.
"""

from __future__ import annotations

from typing import Any

from .backend import BOTTOM, EMPTY, ThreadBackend
from .max_register import AtomicMaxRegister, TreeMaxRegister
from .storage import make_store


class WSMult:
    OWNER = 0

    def __init__(
        self,
        backend=None,
        max_register: str = "tree",
        capacity: int = 1 << 20,
        storage: str = "infinite",
        put_order: str = "task_first",
        **store_kw: Any,
    ):
        backend = backend if backend is not None else ThreadBackend()
        self.backend = backend
        if max_register == "tree":
            self.head_reg = TreeMaxRegister(capacity + 2, backend)
            self.head_reg.max_write(1, self.OWNER)  # Head initialized to 1
        elif max_register == "atomic":
            self.head_reg = AtomicMaxRegister(backend, init=1)
        else:
            raise ValueError(max_register)
        self.tasks = make_store(storage, backend, **store_kw)
        # first two objects initialized to ⊥
        self.tasks.write(1, BOTTOM, self.OWNER)
        self.tasks.write(2, BOTTOM, self.OWNER)
        self.tail = 0  # owner-local persistent variable
        self.put_order = put_order

    # -- owner ----------------------------------------------------------
    def put(self, x: Any) -> bool:
        pid = self.OWNER
        self.tail += 1  # line 1 (local)
        if self.put_order == "task_first":  # line 2: {W(tail,x), W(tail+2,⊥)}
            self.tasks.write(self.tail, x, pid)
            self.tasks.write(self.tail + 2, BOTTOM, pid)
        else:
            self.tasks.write(self.tail + 2, BOTTOM, pid)
            self.tasks.write(self.tail, x, pid)
        return True  # line 3

    def take(self) -> Any:
        pid = self.OWNER
        head = self.head_reg.max_read(pid)  # line 4
        if head <= self.tail:  # line 5
            x = self.tasks.read(head, pid)  # line 6 (either order)
            self.head_reg.max_write(head + 1, pid)
            return x  # line 7
        return EMPTY  # line 9

    # -- thieves ----------------------------------------------------------
    def steal(self, pid: int) -> Any:
        head = self.head_reg.max_read(pid)  # line 10
        x = self.tasks.read(head, pid)  # line 11
        if x is not BOTTOM:  # line 12
            self.head_reg.max_write(head + 1, pid)  # line 13
            return x  # line 14
        return EMPTY  # line 16
