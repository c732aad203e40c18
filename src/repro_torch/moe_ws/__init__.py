"""Dropless MoE expert dispatch on the fence-free work-stealing scheduler
(port of ``repro.moe_ws``).

Per-expert token lists become task queues (:mod:`.dispatch`: the host Put
and the shared-pool Put), expert FFN tiles run through the hand-written
expert megakernel ``csrc/ws_expert.cu`` and their transpose through
``csrc/ws_expert_grad.cu`` (:mod:`.expert_kernel`), and the layer's
combine and custom backward normalise duplicated tiles by their
multiplicity (:mod:`.layer`).
"""

from .dispatch import (
    MoEDispatchHost,
    RoutedSet,
    divisor_from_tiles,
    expert_queue_candidates,
    expert_rounds_bound,
    route_to_tasks,
    route_to_tasks_pool,
    route_to_tasks_pool_torch,
    route_to_tasks_torch,
    row_divisor,
)
from .expert_kernel import (
    dsilu,
    grad_out_width,
    launch_moe_grad_grid,
    launch_moe_grid,
    plain_moe_grad_grid,
    plain_moe_grid,
    run_moe_grad_schedule,
    run_moe_schedule,
)
from .layer import (
    GRAD_DISPATCHES,
    DispatchStats,
    combine_routed,
    expert_ffn_nodrop_ref,
    moe_ffn_nodrop_ref,
    moe_ffn_ws,
)

__all__ = [
    "DispatchStats", "GRAD_DISPATCHES", "MoEDispatchHost", "RoutedSet", "combine_routed",
    "divisor_from_tiles", "dsilu", "expert_ffn_nodrop_ref", "expert_queue_candidates",
    "expert_rounds_bound",
    "grad_out_width", "launch_moe_grad_grid", "launch_moe_grid", "moe_ffn_nodrop_ref",
    "moe_ffn_ws", "plain_moe_grad_grid", "plain_moe_grid", "route_to_tasks",
    "route_to_tasks_pool", "route_to_tasks_pool_torch", "route_to_tasks_torch", "row_divisor",
    "run_moe_grad_schedule", "run_moe_schedule",
]
