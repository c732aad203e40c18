"""Deterministic-interleaving harness + property checkers for the core queues
(copy of ``repro/core/simulator.py``).

``run_program`` executes per-process operation sequences under a supplied
schedule (sequence of pids deciding which process performs the next
shared-memory step) and returns timestamped :class:`OpRecord`s.  The property
checkers encode the paper's correctness conditions:

* weak multiplicity (Def. 4.1 consequence): each process extracts a task at
  most once; every extracted-past task was extracted at least once (no loss).
* multiplicity (Def. 3.1 / Remark 3.2): additionally, all operations that
  return the same task are *pairwise concurrent*.
* sequentially-exact (Remark 3.1 / §4): a sequential execution behaves like
  exact FIFO work-stealing.

These are necessary conditions implied by (set-)linearizability and are what
the hypothesis property tests check over randomized adversarial schedules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

from .backend import EMPTY, SimBackend, SimController, set_sim_pid


@dataclass
class OpRecord:
    pid: int
    kind: str  # 'put' | 'take' | 'steal'
    arg: Any
    result: Any
    inv: int  # controller step count at invocation
    res: int  # controller step count at response

    def overlaps(self, other: "OpRecord") -> bool:
        """op || op' in the sense of §2 (neither response precedes the other's
        invocation)."""
        return not (self.res <= other.inv or other.res <= self.inv)


Program = Dict[int, List[Tuple[str, Any]]]  # pid -> [(kind, arg), ...]


def run_program(
    make_queue: Callable[[Any], Any],
    program: Program,
    schedule: Sequence[int],
    timeout: float = 60.0,
) -> List[OpRecord]:
    """Run ``program`` on a fresh queue under ``schedule``; return op records."""
    ctrl = SimController(schedule)
    backend = SimBackend(ctrl)
    q = make_queue(backend)
    records: List[OpRecord] = []

    def runner(pid: int, ops: List[Tuple[str, Any]]) -> None:
        set_sim_pid(pid)
        for kind, arg in ops:
            inv = ctrl.now()
            if kind == "put":
                r = q.put(arg)
            elif kind == "take":
                r = q.take()
            elif kind == "steal":
                r = q.steal(pid)
            else:
                raise ValueError(kind)
            records.append(OpRecord(pid, kind, arg, r, inv, ctrl.now()))

    ctrl.run(
        {pid: (lambda pid=pid, ops=ops: runner(pid, ops)) for pid, ops in program.items()},
        timeout=timeout,
    )
    return records


def extractions(records: List[OpRecord]) -> List[OpRecord]:
    return [r for r in records if r.kind in ("take", "steal") and r.result is not EMPTY]


def check_no_process_duplicates(records: List[OpRecord]) -> None:
    """Each process extracts a given task at most once (multiplicity family)."""
    seen = set()
    for r in extractions(records):
        key = (r.pid, r.result)
        assert key not in seen, (
            f"process {r.pid} extracted task {r.result!r} more than once "
            f"(violates weak multiplicity)"
        )
        seen.add(key)


def check_no_lost_tasks_fifo(records: List[OpRecord]) -> None:
    """FIFO at-least-once: nothing older than the newest extracted task was skipped.

    Put values must be distinct for this check (tests put 1..k).
    """
    put_order = [r.arg for r in records if r.kind == "put"]
    got = {r.result for r in extractions(records)}
    if not got:
        return
    newest = max(put_order.index(v) for v in got)
    for v in put_order[: newest + 1]:
        assert v in got, f"task {v!r} was skipped (lost) — violates at-least-once"


def check_pairwise_concurrent_duplicates(records: List[OpRecord]) -> None:
    """Multiplicity (Def. 3.1): same-task extractors are pairwise concurrent."""
    by_task: Dict[Any, List[OpRecord]] = {}
    for r in extractions(records):
        by_task.setdefault(r.result, []).append(r)
    for task, ops in by_task.items():
        for i in range(len(ops)):
            for j in range(i + 1, len(ops)):
                assert ops[i].overlaps(ops[j]), (
                    f"task {task!r} extracted by non-concurrent operations "
                    f"{ops[i]} and {ops[j]} (violates multiplicity)"
                )


def check_owner_fifo(records: List[OpRecord]) -> None:
    """The owner's successful Takes return tasks in strictly increasing put order."""
    put_order = [r.arg for r in records if r.kind == "put"]
    idx = {v: i for i, v in enumerate(put_order)}
    last = -1
    for r in records:
        if r.pid == 0 and r.kind == "take" and r.result is not EMPTY:
            assert idx[r.result] > last, (
                f"owner takes out of FIFO order: {r.result!r} after index {last}"
            )
            last = idx[r.result]


def run_sequential(queue, program_flat: List[Tuple[int, str, Any]]):
    """Execute ops one-at-a-time (a sequential execution in the paper's sense).

    ``queue`` should be built on ThreadBackend; with a single caller thread the
    execution is trivially sequential.  Returns [(pid, kind, arg, result)].
    """
    out = []
    for pid, kind, arg in program_flat:
        if kind == "put":
            r = queue.put(arg)
        elif kind == "take":
            r = queue.take()
        else:
            r = queue.steal(pid)
        out.append((pid, kind, arg, r))
    return out


class ExactFIFOOracle:
    """Reference exact FIFO work-stealing semantics (Def. 3.1 restricted to
    singleton concurrency classes) for sequentially-exact checks."""

    def __init__(self):
        self.q: List[Any] = []

    def put(self, x):
        self.q.append(x)
        return True

    def take(self):
        return self.q.pop(0) if self.q else EMPTY

    def steal(self, pid):
        return self.q.pop(0) if self.q else EMPTY


class ExactLIFOOracle:
    """Owner-LIFO oracle for the deque-order baselines in sequential
    executions.  ``steal_end='head'`` for Chase-Lev / THE Cilk / idempotent
    deque (thieves at the opposite end); ``steal_end='tail'`` for the
    idempotent LIFO stack (thieves pop the same end as the owner)."""

    def __init__(self, steal_end: str = "head"):
        self.q: List[Any] = []
        self.steal_end = steal_end

    def put(self, x):
        self.q.append(x)
        return True

    def take(self):
        return self.q.pop() if self.q else EMPTY

    def steal(self, pid):
        if not self.q:
            return EMPTY
        return self.q.pop(0) if self.steal_end == "head" else self.q.pop()
