"""Cross-device expert-parallel work stealing over a mesh of ranks (port of
``repro.mesh_ws``).

Splits ``moe_ws``'s expert queues along the mesh's ``"model"`` axis and
lets advisory-idle devices steal remote expert tiles through two levels: a
local drain on the expert megakernel, then a replicated deterministic steal
plan computed from coalesced per-device advisories, exchanged by ring hops,
point-to-point sends of a victim's weights to its thieves and sums over
``torch.distributed`` process groups (plain-write summaries and
data-parallel collectives; no atomics, no fences).  The devices are
ranks (:mod:`repro_torch.launch.mesh`); several may share one card.
"""

from .advisory import (
    apply_donation,
    donated_cost,
    exchange_payload_bytes,
    reduce_advisory,
    ring_allgather,
)
from .layer import (
    MESH_AXIS,
    TELE_FIELDS,
    EmulatedDispatch,
    emulate_mesh_dispatch,
    expert_ffn_mesh_ws,
    mesh_dispatch_body,
    mesh_wstrace,
    moe_ffn_mesh_ws,
    phase_rounds,
)
from .partition import (
    LocalPut,
    expert_shard,
    local_pool_state,
    route_local_pool_torch,
)
from .steal import (
    StealPlan,
    deliver_home,
    hops_matrix,
    plan_steals,
    plan_steals_all,
    send_stolen_shards,
    steal_pairs,
    steal_queue_state,
)

__all__ = [
    "MESH_AXIS",
    "TELE_FIELDS",
    "EmulatedDispatch",
    "LocalPut",
    "StealPlan",
    "apply_donation",
    "deliver_home",
    "donated_cost",
    "emulate_mesh_dispatch",
    "exchange_payload_bytes",
    "expert_ffn_mesh_ws",
    "expert_shard",
    "hops_matrix",
    "local_pool_state",
    "mesh_dispatch_body",
    "mesh_wstrace",
    "moe_ffn_mesh_ws",
    "phase_rounds",
    "plan_steals",
    "plan_steals_all",
    "reduce_advisory",
    "ring_allgather",
    "route_local_pool_torch",
    "send_stolen_shards",
    "steal_pairs",
    "steal_queue_state",
]
