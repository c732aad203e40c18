"""The paper's work-stealing as the training path's gradient accumulation
(``repro.sched`` counterpart).

Per-worker FIFO queues of microbatch tasks; Take and Steal on each worker's
stale local view of every queue head (the RangeMaxRegister), the true head
being the max over views; duplicates counted and divided back out of the
gradient by ``1/count`` (weak multiplicity).  Modes: ``static`` (no
stealing), ``ws-mult`` (views unified and claims arbitrated every round),
``ws-mult-ranked`` (synced views, distinct steal slots), ``ws-wmult``
(stale views, an asynchronous board every ``sync_every`` rounds),
``ws-wmult-deque`` (thieves from the tail behind a reverse watermark).
"""

from .policy import pick_ranked, pick_tasks, resolve_claims, sync_views
from .rounds import MODES, RoundStats, run_lockstep_rounds, schedule_rounds
from .simulator import async_makespan
from .accumulate import ws_accumulate_grads

__all__ = [
    "MODES",
    "RoundStats",
    "async_makespan",
    "pick_ranked",
    "pick_tasks",
    "resolve_claims",
    "run_lockstep_rounds",
    "schedule_rounds",
    "sync_views",
    "ws_accumulate_grads",
]
