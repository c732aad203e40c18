"""Per-program task queues as flat int32 arrays (WS-WMULT Fig. 7), the
host Puts — port of ``repro/pallas_ws/queues.py`` (the dense host Put
:func:`make_queue_state`, the stage-gated Put
:func:`make_staged_queue_state` and the shared-pool Put
:func:`make_pool_queue_state`).

==========================  =====================================================
paper (Fig. 7)              array (plain loads/stores only)
==========================  =====================================================
``tasks[1..∞]`` per queue   ``tasks[q, s, :]``  [n_queues, capacity, TASK_WIDTH]
``Head`` register           ``head[q]``         [n_queues]
process-local ``head``      ``local_head[p, q]`` [n_programs, n_queues]
(announcement)              ``taken[q, s]``     [n_queues, capacity]
``tail`` (owner-local)      ``tail[q]``         [n_queues], static: Puts happen
                                                 before the launch
==========================  =====================================================

Two layouts share :class:`QueueState`.  **Dense**: ``tasks[q, s]`` with a
static per-queue capacity.  **Shared pool** (``pool_off`` set): one flat
slot pool ``tasks[j]`` in which queue ``q`` owns the contiguous segment
``[pool_off[q], pool_off[q] + tail[q])``; slot ``(q, s)`` is pool index
``pool_off[q] + s`` and ``taken`` is flat ``[pool_slots]``, so the pool
never pays the dense layout's per-queue worst-case padding.

A host-built state holds numpy arrays; :func:`to_device` turns it into a
state of device tensors once, so a decode step can launch the same Put in
every layer without uploading it again (each launch clones the mutable
arrays, so the state itself is never consumed).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .tasks import BOTTOM, F_COST, F_OP, TASK_WIDTH, ExpertTask, StepGlueTask, TileTask

Task = Union[TileTask, ExpertTask, StepGlueTask]


@dataclass
class QueueState:
    """The Fig. 7 arrays (numpy on the host, or tensors after :func:`to_device`).

    ``remaining[q]`` is the advisory per-queue cost summary the cost-aware
    victim choice ranks by: initialised to the enqueued cost, decremented
    best-effort by claimants; stale values mis-rank victims, nothing more.
    """

    tasks: np.ndarray        # [n_queues, capacity, TASK_WIDTH] | pool: [pool_slots, TASK_WIDTH]
    head: np.ndarray         # [n_queues]
    tail: np.ndarray         # [n_queues]
    local_head: np.ndarray   # [n_programs, n_queues]
    taken: np.ndarray        # [n_queues, capacity] | pool: [pool_slots]; -1 = not extracted
    task_list: Optional[List[Task]] = None
    remaining: Optional[np.ndarray] = None  # [n_queues]
    n_tasks_hint: Optional[int] = None      # multiplicity slots when task_list is None
    pool_off: Optional[np.ndarray] = None   # [n_queues + 1] pool segment offsets

    @property
    def pool(self) -> bool:
        return self.pool_off is not None

    @property
    def n_queues(self) -> int:
        return self.head.shape[0]

    @property
    def n_programs(self) -> int:
        return self.local_head.shape[0]

    @property
    def capacity(self) -> int:
        """Bound on slot indices: per queue (dense), the whole pool (pool)."""
        return self.tasks.shape[0] if self.pool else self.tasks.shape[1]

    @property
    def n_tasks(self) -> int:
        if self.task_list is not None:
            return len(self.task_list)
        return self.n_tasks_hint or 0


def partition_tasks(
    tasks: Sequence[Task], n_queues: int, partition: str = "owner"
) -> List[List[Task]]:
    """``"owner"``/``"batch"``: queue ``task.owner % n_queues`` (a batch row
    for attention, an expert for MoE dispatch: the skew the thieves erase);
    ``"round_robin"``: task-index striping."""
    buckets: List[List[Task]] = [[] for _ in range(n_queues)]
    for i, t in enumerate(tasks):
        q = (t.owner if partition in ("owner", "batch") else i) % n_queues
        buckets[q].append(t)
    return buckets


def make_queue_state(
    tasks: Sequence[Task],
    n_programs: int,
    n_queues: int | None = None,
    partition: str = "batch",
) -> QueueState:
    """Lay tasks out in the Fig. 7 format; slots past each tail stay ⊥."""
    n_queues = n_programs if n_queues is None else n_queues
    return _dense_state(partition_tasks(tasks, n_queues, partition), n_programs,
                        list(tasks))


def make_staged_queue_state(
    stages: Sequence[Sequence[Task]],
    n_programs: int,
    *,
    n_queues_per_stage: Optional[int] = None,
    partition: str = "owner",
) -> Tuple[QueueState, np.ndarray, int]:
    """The host Put of a stage-gated launch (the unified engine step).

    ``stages[s]`` is stage ``s``'s task list (any family).  Each stage gets
    its own block of queues, laid out stage-major, and queue ``q`` of stage
    ``s`` opens to Take/Steal at round ``open[s]``: the prefix sums of each
    stage's Graham bound

        open[0] = 0;  open[s+1] = open[s] + ceil(W_s / P) + max_cost_s

    (``W_s`` the stage's total cost).  An idle program claims whenever an
    open queue is non-empty, so every stage-``s`` task has finished by
    ``open[s+1]`` in a lockstep walk: the dependency between stages is a
    pure input, with no waiting on the device.

    Returns ``(state, stage_open, rounds)``: ``stage_open`` per queue
    ([n_queues] int32, nondecreasing) and ``rounds = max(1, open[-1])``.
    """
    q_s = n_programs if n_queues_per_stage is None else n_queues_per_stage
    buckets: List[List[Task]] = []
    opens = [0]
    task_list: List[Task] = []
    for tasks in stages:
        buckets += partition_tasks(tasks, q_s, partition)
        task_list += list(tasks)
        total = sum(t.cost for t in tasks)
        mc = max((t.cost for t in tasks), default=0)
        opens.append(opens[-1] + ((-(-total // n_programs) + mc) if tasks else 0))
    state = _dense_state(buckets, n_programs, task_list)
    stage_open = np.repeat(np.asarray(opens[:-1], dtype=np.int32), q_s)
    return state, stage_open, max(1, opens[-1])


def _dense_state(buckets: List[List[Task]], n_programs: int,
                 task_list: List[Task]) -> QueueState:
    """The dense Fig. 7 arrays of per-queue task lists."""
    n_queues = len(buckets)
    cap = max(4, max((len(b) for b in buckets), default=0) + 2)
    arr = np.full((n_queues, cap, TASK_WIDTH), BOTTOM, dtype=np.int32)
    tail = np.zeros((n_queues,), dtype=np.int32)
    remaining = np.zeros((n_queues,), dtype=np.int32)
    for q, bucket in enumerate(buckets):
        for s, t in enumerate(bucket):
            arr[q, s] = t.encode()
        tail[q] = len(bucket)
        remaining[q] = sum(t.cost for t in bucket)
    return QueueState(
        tasks=arr,
        head=np.zeros((n_queues,), dtype=np.int32),
        tail=tail,
        local_head=np.zeros((n_programs, n_queues), dtype=np.int32),
        taken=np.full((n_queues, cap), -1, dtype=np.int32),
        task_list=task_list,
        remaining=remaining,
    )


def make_pool_queue_state(records, tail, pool_off, remaining, n_programs: int, *,
                          n_tasks: int) -> QueueState:
    """The shared-pool Put: wrap pre-compacted flat records.

    ``records``: [pool_slots, TASK_WIDTH], where queue ``q``'s live slots
    already fill the segment ``[pool_off[q], pool_off[q] + tail[q])`` in
    queue order and the pool suffix is all ⊥ (as
    :func:`repro_torch.moe_ws.dispatch.route_to_tasks_pool` builds them);
    ``pool_off``: [n_queues + 1]; ``tail``: [n_queues] live slots per
    queue; ``remaining``: [n_queues] initial advisories.  ``n_tasks`` sizes
    the multiplicity buffer: pool slot index == ``tid`` == multiplicity
    index, so the dead suffix keeps ``mult == 0``.
    """
    records = np.asarray(records, dtype=np.int32)
    tail = np.asarray(tail, dtype=np.int32)
    n_queues = tail.shape[0]
    return QueueState(
        tasks=records,
        head=np.zeros((n_queues,), dtype=np.int32),
        tail=tail,
        local_head=np.zeros((n_programs, n_queues), dtype=np.int32),
        taken=np.full((records.shape[0],), -1, dtype=np.int32),
        task_list=None,
        remaining=np.asarray(remaining, dtype=np.int32),
        n_tasks_hint=int(n_tasks),
        pool_off=np.asarray(pool_off, dtype=np.int32),
    )


def copy_state(state: QueueState) -> QueueState:
    """Independent copy (arrays copied, task_list shared: tasks are
    immutable records).  Drills mutate head/local bounds in place; the
    fault-free oracle runs from a pristine copy."""

    def cp(a):
        if a is None:
            return None
        return a.clone() if isinstance(a, torch.Tensor) else np.array(a)

    return QueueState(
        tasks=cp(state.tasks),
        head=cp(state.head),
        tail=cp(state.tail),
        local_head=cp(state.local_head),
        taken=cp(state.taken),
        task_list=state.task_list,
        remaining=cp(state.remaining),
        n_tasks_hint=state.n_tasks_hint,
        pool_off=cp(state.pool_off),
    )


def host_array(a) -> np.ndarray:
    """numpy view of a host array or a (possibly device) tensor."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def queue_costs(state: QueueState) -> np.ndarray:
    """Total tile-slot cost enqueued per queue (the static-schedule load)."""
    tasks = host_array(state.tasks)
    if state.pool:
        off, tail = host_array(state.pool_off), host_array(state.tail)
        costs = np.zeros((state.n_queues,), dtype=np.int64)
        live = tasks[:, F_OP] != BOTTOM
        for q in range(state.n_queues):
            seg = slice(int(off[q]), int(off[q]) + int(tail[q]))
            costs[q] = np.where(live[seg], tasks[seg, F_COST], 0).sum()
        return costs
    live = tasks[:, :, F_OP] != BOTTOM
    return np.where(live, tasks[:, :, F_COST], 0).sum(axis=1)


def to_device(state: QueueState, device) -> QueueState:
    """The same state with every array an int32 tensor on ``device``."""
    remaining = state.remaining
    if remaining is None:
        remaining = queue_costs(state).astype(np.int32)

    def dev(a):
        return torch.as_tensor(host_array(a), dtype=torch.int32).to(device)

    return replace(
        state,
        tasks=dev(state.tasks), head=dev(state.head), tail=dev(state.tail),
        local_head=dev(state.local_head), taken=dev(state.taken),
        remaining=dev(remaining),
        pool_off=None if state.pool_off is None else dev(state.pool_off),
    )
