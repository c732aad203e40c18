"""Host-side work-stealing data loader — the paper's L2 deployment (port of
``repro/data/loader.py``).

The *literal* WS-WMULT algorithm (``repro_torch.core``, Figure 7) runs on Python
threads: the owner (feeder) Puts batch-preparation tasks; worker threads
Take/Steal them and materialize the numpy microbatches.  Weak multiplicity
means a microbatch may be materialized twice under contention; preparation
is idempotent (deterministic synthetic corpus), and the assembly point
deduplicates by task id — exactly the paper's "repeatable work" deployment
(§1: idempotent contexts), with the stronger ≤-once-per-thread guarantee.

This is deliberately the real algorithm rather than a queue.Queue: the
loader doubles as a liveness/soak test of the core implementation, and its
stats count the extractions and the duplicates.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

from repro_torch.core import EMPTY, WSWMult


class WorkStealingLoader:
    """Prefetching loader over an idempotent `prepare(task_id) -> batch` fn."""

    def __init__(
        self,
        prepare: Callable[[int], dict],
        n_tasks: int,
        n_workers: int = 2,
        storage: str = "linked",
        node_len: int = 64,
    ):
        self.prepare = prepare
        self.n_tasks = n_tasks
        self.queue = WSWMult(storage=storage, node_len=node_len)
        self._results: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.stats = {"extractions": 0, "duplicates": 0}
        self._workers = [
            threading.Thread(target=self._worker, args=(pid,), daemon=True)
            for pid in range(1, n_workers + 1)
        ]

    # -- owner thread -------------------------------------------------------
    def start(self):
        for t in range(self.n_tasks):
            self.queue.put(t)
        for w in self._workers:
            w.start()
        # the owner also works (Take), per the paper's roles
        while True:
            task = self.queue.take()
            if task is EMPTY:
                break
            self._complete(task)
        return self

    # -- thief threads --------------------------------------------------------
    def _worker(self, pid: int):
        misses = 0
        while not self._done.is_set() and misses < 64:
            task = self.queue.steal(pid)
            if task is EMPTY:
                misses += 1
                continue
            misses = 0
            self._complete(task)

    def _complete(self, task_id: int):
        batch = self.prepare(task_id)  # idempotent; may run more than once
        with self._lock:
            self.stats["extractions"] += 1
            if task_id in self._results:
                self.stats["duplicates"] += 1  # weak multiplicity in action
            else:
                self._results[task_id] = batch
            if len(self._results) == self.n_tasks:
                self._done.set()

    # -- consumer -------------------------------------------------------------
    def batches(self, timeout: float = 60.0) -> List[dict]:
        """Block until every task is materialized at least once (the paper's
        at-least-once guarantee), then return batches in task order."""
        if not self._done.wait(timeout):
            missing = [t for t in range(self.n_tasks) if t not in self._results]
            raise TimeoutError(f"loader incomplete; missing tasks {missing[:8]}...")
        return [self._results[t] for t in range(self.n_tasks)]
