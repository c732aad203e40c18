"""Work-stealing tile scheduler on the GPU (port of ``repro.pallas_ws``)."""

from .host import PallasWSHost
from .kernel import (
    MODES,
    STEAL_POLICIES,
    DrainCounter,
    WSRunResult,
    default_rounds,
    launch_ws_grid,
    launches,
    plain_ws_grid,
    reset_launches,
    run_ws_schedule,
)
from .queues import (
    QueueState,
    copy_state,
    make_pool_queue_state,
    make_queue_state,
    make_queue_state_torch,
    owner_queue_candidates,
    partition_tasks,
    queue_costs,
    to_device,
)
from .ragged import (
    RaggedStats,
    decode_queue_state,
    decode_rounds_bound,
    emit_decode_tasks_torch,
    normalized_out,
    ragged_attention_ref,
    ragged_decode_attention,
    ragged_decode_ref,
    ragged_flash_attention,
)
from .tasks import (
    BOTTOM,
    OP_EXPERT_TILE,
    TASK_WIDTH,
    ExpertTask,
    TileTask,
    emit_decode_tasks,
    emit_flash_tasks,
    multiplicity_divisor,
)

__all__ = [
    "BOTTOM", "MODES", "OP_EXPERT_TILE", "STEAL_POLICIES", "TASK_WIDTH", "DrainCounter",
    "ExpertTask", "PallasWSHost", "QueueState", "RaggedStats",
    "TileTask", "WSRunResult", "copy_state", "decode_queue_state", "decode_rounds_bound",
    "default_rounds",
    "emit_decode_tasks", "emit_decode_tasks_torch", "emit_flash_tasks", "launch_ws_grid",
    "launches", "make_pool_queue_state", "make_queue_state", "make_queue_state_torch",
    "multiplicity_divisor", "normalized_out", "owner_queue_candidates", "partition_tasks",
    "plain_ws_grid", "queue_costs", "ragged_attention_ref", "ragged_decode_attention",
    "ragged_decode_ref", "ragged_flash_attention",
    "reset_launches", "run_ws_schedule", "to_device",
]
