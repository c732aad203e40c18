"""Device event-ring schema and host-side decode (copy of
``repro/wstrace/ring.py``; numpy only).

Device half (``csrc/ws_sched.cuh``, the traced instantiation of both walks,
and ``pallas_ws.kernel._PlainWalk``): every successful Take/Steal appends one
fixed-width int32 record to the claiming program's row of a preallocated
``[n_programs, capacity, EVENT_WIDTH]`` array, then bumps that program's
cursor.  Record stores and the cursor bump are plain stores: no atomic, no
fence, so tracing stays inside the fence-free audit.

Rings never wrap: a record is written only while ``cursor < capacity``
(overflow drops, the run's prefix survives), but the cursor keeps counting,
so the host recovers the number of dropped events as
``max(0, cursor - capacity)`` per program.

Record fields (all int32):

=========  ================================================================
EV_ROUND   start of the execution in tile-slots.  Lockstep: the virtual
           round ``max(clock[p], r)`` read before the clock bump, so
           ``[round, round + cost)`` is the interval the program was busy.
           Free mode (no rounds): ``clock[p]`` before the bump, the costs
           the program ran so far plus its initial stall, the same interval
           on the program's own clock
EV_PROG    claiming program (redundant with the ring row; kept so a
           flattened stream is self-describing)
EV_QUEUE   queue the slot was claimed from
EV_SLOT    logical slot index within that queue
EV_TID     task id of the claimed record
EV_COST    task cost in tile-slots
EV_KIND    KIND_TAKE / KIND_STEAL_SCAN / KIND_STEAL_COST / KIND_STEAL_REMOTE
EV_VICTIM  owner program of the stolen queue (steals of a queue
           ``< n_programs``); -1 for takes and unowned queues
EV_MULT    the task's multiplicity after this execution (free mode: the
           carried count plus this program's own executions; the other
           programs' rows cannot be read without a race)
EV_OP      the claimed record's op id (``tasks.F_OP``), so a mixed launch
           (the unified step) decodes into per-family timelines
EV_RUN     slots claimed by the extraction (1: single-slot Take/Steal)
=========  ================================================================
"""

from __future__ import annotations

import numpy as np

EVENT_WIDTH = 11
(EV_ROUND, EV_PROG, EV_QUEUE, EV_SLOT, EV_TID, EV_COST, EV_KIND, EV_VICTIM,
 EV_MULT, EV_OP, EV_RUN) = range(EVENT_WIDTH)

KIND_TAKE = 0
KIND_STEAL_SCAN = 1
KIND_STEAL_COST = 2
KIND_STEAL_REMOTE = 3
KIND_NAMES = ("take", "steal-scan", "steal-cost", "steal-remote")
STEAL_KINDS = (KIND_STEAL_SCAN, KIND_STEAL_COST, KIND_STEAL_REMOTE)


def host(a) -> np.ndarray:
    """numpy copy-free view of a host array or a (possibly device) tensor."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def decode_rings(events, cursor):
    """Flatten per-program rings into one event stream.

    ``events``: ``[n_programs, capacity, EVENT_WIDTH]`` int32 (unwritten
    slots hold -1), numpy or a tensor on any device; ``cursor``: ``[n_programs]`` total appends *attempted*
    per program (valid records are the first ``min(cursor, capacity)``).

    Returns ``(stream, dropped)`` — ``stream`` is ``[n_events, EVENT_WIDTH]``
    sorted by (round, program) so it reads as a timeline, ``dropped`` is the
    per-program count of records lost to ring overflow.
    """
    events, cursor = host(events), host(cursor)
    n_programs, capacity, width = events.shape
    assert width == EVENT_WIDTH, events.shape
    # Row-major boolean selection over [P, cap] is exactly the per-program
    # prefix concatenation (program-major, slot order preserved) the old
    # Python loop produced — one vectorized gather instead of P slices.
    valid = np.arange(capacity)[None, :] < np.minimum(cursor, capacity)[:, None]
    stream = events[valid].reshape(-1, EVENT_WIDTH)
    if stream.size:
        order = np.lexsort((stream[:, EV_PROG], stream[:, EV_ROUND]))
        stream = stream[order]
    dropped = np.maximum(cursor.astype(np.int64) - capacity, 0)
    return stream.astype(np.int32, copy=False), dropped
