"""Task records of the work-stealing tile scheduler (port of
``repro/pallas_ws/tasks.py``: the attention, expert and step-glue families).

A task is one idempotent tile: a fixed-width int32 record in the Fig. 7
``tasks`` array, where ``tasks[i] = ⊥`` is "field 0 == BOTTOM".  Executing
a task computes its whole, disjoint output slice; ``mult[tid]`` counts
executions so duplicates from the relaxed scheduler can be divided back
out (lockstep accumulate) or are harmless (free-mode plain store).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# int32 sentinel marking a never-filled task slot (the paper's ⊥).
BOTTOM = -1

# Record layout: 8 × int32 per task.  Field 0 and the tail two fields are
# family-agnostic; fields 1-5 are the family's operands.
TASK_WIDTH = 8
F_OP = 0      # op id (>= 0 live; BOTTOM empty)
F_B = 1       # batch row
F_H = 2       # query head
F_QS = 3      # first q row of the tile
F_QL = 4      # number of live q rows (< bq on a ragged tail tile)
F_KV = 5      # kv end, exclusive (== sequence length)
F_TID = 6     # global task id (indexes the multiplicity counters)
F_COST = 7    # tile-slots (kv blocks) this task occupies

# Expert family (fields 1-3; 4-5 unused, BOTTOM).
F_E = 1       # expert id
F_RS = 2      # first routed row of the tile
F_RL = 3      # live routed rows (< bt on an expert's tail tile)

# Step-glue family (fields 1-3; 4-5 unused, BOTTOM).
F_PHASE = 1   # glue phase (models.unified.GLUE_* codes)
F_LAYER = 2   # transformer layer the glue belongs to
F_AUX = 3     # phase operand (BOTTOM if unused)

OP_FLASH_TILE = 0
OP_DECODE_TILE = 1
OP_EXPERT_TILE = 2
OP_STEP_GLUE = 3


@dataclass(frozen=True)
class TaskFamily:
    """One workload on the shared queue/kernel/clock machinery.

    ``ops``: the op codes the family owns; ``operands``: record fields 1-5 by
    name; ``cost_unit``: what one tile-slot of :data:`F_COST` measures, so
    makespans compare only within a family.
    """

    name: str
    ops: Tuple[int, ...]
    operands: Tuple[str, ...]
    cost_unit: str


TASK_FAMILIES: Dict[str, TaskFamily] = {}
_OP_TO_FAMILY: Dict[int, TaskFamily] = {}


def register_family(family: TaskFamily) -> TaskFamily:
    """Register a task family; op codes must be globally unique."""
    for op in family.ops:
        prev = _OP_TO_FAMILY.get(op)
        if prev is not None and prev.name != family.name:
            raise ValueError(f"op {op} already owned by family {prev.name!r}")
        _OP_TO_FAMILY[op] = family
    TASK_FAMILIES[family.name] = family
    return family


def family_of(op: int) -> TaskFamily:
    return _OP_TO_FAMILY[op]


ATTENTION_FAMILY = register_family(TaskFamily(
    name="attention", ops=(OP_FLASH_TILE, OP_DECODE_TILE),
    operands=("b", "h", "q_start", "q_len", "kv_end"), cost_unit="kv blocks"))
EXPERT_FAMILY = register_family(TaskFamily(
    name="expert", ops=(OP_EXPERT_TILE,), operands=("expert", "row_start", "row_len"),
    cost_unit="routed token rows"))
# The unified step's inter-stage glue: one task per (phase, layer), whose
# cost is the whole phase's work.
STEP_FAMILY = register_family(TaskFamily(
    name="step-glue", ops=(OP_STEP_GLUE,), operands=("phase", "layer", "aux"),
    cost_unit="glue phases"))


@dataclass(frozen=True)
class TileTask:
    """Attention-family task: one (b, h, q-block) tile sweeping kv [0, kv_end)."""

    op: int
    b: int
    h: int
    q_start: int
    q_len: int
    kv_end: int
    tid: int
    cost: int

    @property
    def owner(self) -> int:
        """Owner-queue key for ``partition_tasks(partition="owner")``."""
        return self.b

    def encode(self) -> np.ndarray:
        return np.array(
            [self.op, self.b, self.h, self.q_start, self.q_len,
             self.kv_end, self.tid, self.cost],
            dtype=np.int32,
        )


@dataclass(frozen=True)
class ExpertTask:
    """Expert-family task: ``row_len`` routed rows of one expert's FFN.

    ``row_start`` indexes the expert-grouped routed arrays (see
    ``moe_ws.dispatch``), so each task owns a disjoint contiguous slice of
    the routed output.  ``cost`` is the number of live rows: expert FFN work
    is tokens × d_ff and d_ff is uniform across experts.
    """

    expert: int
    row_start: int
    row_len: int
    tid: int
    cost: int
    op: int = OP_EXPERT_TILE

    @property
    def owner(self) -> int:
        return self.expert

    def encode(self) -> np.ndarray:
        return np.array(
            [self.op, self.expert, self.row_start, self.row_len,
             BOTTOM, BOTTOM, self.tid, self.cost],
            dtype=np.int32,
        )


@dataclass(frozen=True)
class StepGlueTask:
    """Step-glue task: one inter-stage phase of the unified engine step.

    Each glue stage holds one such task, and the stage windows serialise
    the phases.  In lockstep one walker claims it exactly once on a fresh
    launch; in free mode several CTAs can claim the same task, so a glue
    body never updates a buffer in place: it reads the previous stage's
    outputs and writes distinct ones, and a duplicate writes the same bits.
    ``mult[tid]`` counts its executions like any task's.
    """

    phase: int
    layer: int
    aux: int
    tid: int
    cost: int
    op: int = OP_STEP_GLUE

    @property
    def owner(self) -> int:
        return self.layer

    def encode(self) -> np.ndarray:
        return np.array(
            [self.op, self.phase, self.layer, self.aux,
             BOTTOM, BOTTOM, self.tid, self.cost],
            dtype=np.int32,
        )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def emit_flash_tasks(lengths, n_heads: int, bq: int, bk: int, causal: bool = True):
    """One task per live (b, h, q-block) of a ragged batch; rows past
    ``lengths[b]`` produce no task."""
    tasks = []
    tid = 0
    for b, ln in enumerate(np.asarray(lengths, dtype=np.int64)):
        ln = int(ln)
        for h in range(n_heads):
            for qi in range(_cdiv(ln, bq)):
                qs = qi * bq
                ql = min(bq, ln - qs)
                kv_end = min(qs + bq, ln) if causal else ln
                cost = max(1, _cdiv(kv_end, bk))
                tasks.append(TileTask(OP_FLASH_TILE, b, h, qs, ql, ln, tid, cost))
                tid += 1
    return tasks


def emit_decode_tasks(lengths, n_heads: int, bk: int):
    """One task per live (b, h): a single query row sweeping kv [0, len)."""
    tasks = []
    tid = 0
    for b, ln in enumerate(np.asarray(lengths, dtype=np.int64)):
        ln = int(ln)
        if ln <= 0:
            continue
        for h in range(n_heads):
            tasks.append(
                TileTask(OP_DECODE_TILE, b, h, 0, 1, ln, tid, max(1, _cdiv(ln, bk)))
            )
            tid += 1
    return tasks


def multiplicity_divisor(tasks, mult, out_shape) -> np.ndarray:
    """Per-output-row divisor [B, H, Sq] for lockstep's accumulated
    duplicates; rows owned by no task get divisor 1 and stay zero."""
    B, H, Sq = out_shape
    mult = np.asarray(mult)
    div = np.ones((B, H, Sq), dtype=np.float32)
    for t in tasks:
        div[t.b, t.h, t.q_start: t.q_start + t.q_len] = max(1, int(mult[t.tid]))
    return div


def max_cost(tasks) -> int:
    return max((t.cost for t in tasks), default=0)
