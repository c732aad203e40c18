"""Dropless MoE expert dispatch on the fence-free work-stealing scheduler
(port of ``repro.moe_ws``, forward path).

Per-expert token lists become task queues (:mod:`.dispatch`, the host Put),
expert FFN tiles run through the hand-written expert megakernel
``csrc/ws_expert.cu`` (:mod:`.expert_kernel`), and the combine normalises
duplicated tiles by their multiplicity (:mod:`.layer`).
"""

from .dispatch import (
    RoutedSet,
    divisor_from_tiles,
    expert_rounds_bound,
    route_to_tasks,
    row_divisor,
)
from .expert_kernel import launch_moe_grid, plain_moe_grid, run_moe_schedule
from .layer import (
    GRAD_DISPATCHES,
    DispatchStats,
    combine_routed,
    expert_ffn_nodrop_ref,
    moe_ffn_nodrop_ref,
    moe_ffn_ws,
)

__all__ = [
    "DispatchStats", "GRAD_DISPATCHES", "RoutedSet", "combine_routed",
    "divisor_from_tiles", "expert_ffn_nodrop_ref", "expert_rounds_bound",
    "launch_moe_grid", "moe_ffn_nodrop_ref", "moe_ffn_ws", "plain_moe_grid",
    "route_to_tasks", "row_divisor", "run_moe_schedule",
]
