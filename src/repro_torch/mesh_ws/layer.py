"""``moe_ffn_mesh_ws``: cross-device expert-parallel work-stealing dispatch
(port of ``repro/mesh_ws/layer.py``).

Two levels, on the paper's fence-free substrate:

* **level 1, inside a device**: each device Puts its local experts' pairs
  into a shared-pool queue layout and drains them through the expert
  megakernel (``csrc/ws_expert.cu`` on the card, its plain walk on the CPU)
  for a *balanced-share* budget (:func:`phase_rounds`);
* **level 2, across devices**: devices exchange one coalesced advisory
  scalar each (``advisory.py``), every device runs the same deterministic
  steal plan (``steal.py``), and phase 2 runs two more launches a device:
  continue the own pool to its donation-cut tails, and run the stolen half
  of the chosen victim's pool, whose weight shard the victim sends to its
  thieves alone.

Stolen contributions ride home on one sum addressed by victim id, and the
combine divides each row by its tile's count before the gate-weighted
reduction, which scatters the rows into (token, choice) pair slots and
reduces them with the oracle's own expression.

The devices are the ranks of a :class:`~repro_torch.launch.mesh.Mesh` (gloo
process groups; several may share one card).  :func:`mesh_dispatch_body` is
one rank's step, the reference's ``shard_map`` body;
:func:`emulate_mesh_dispatch` runs the same protocol in one process with
every collective replaced by stacking, for the adversarial drills.

**Modes.**  ``mode="lockstep"`` is the reference's: every launch walks the
reference's order, ``out`` accumulates ``tile × mult``, and the combine
divides by the merged execution count.  ``mode="free"`` (the default, as the
port's kernels) launches P concurrent programs that store whole normalised
tiles and may run a tile more than once; there the divisor is the number of
*devices whose launches wrote the tile* (the owner, plus each delivering
thief), not the executions.  Phase 1 must stop early for anyone to steal:
lockstep cuts it at ``r1`` rounds, and in free mode it is launched as the
kernel's traced instantiation, which reads ``r1`` as each program's budget
in tile-slots (the untraced free walk drains everything).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import resolve_axis
from repro_torch.moe_ws.dispatch import divisor_from_tiles
from repro_torch.moe_ws.expert_kernel import run_moe_schedule
from repro_torch.pallas_ws.kernel import MODES
from repro_torch.pallas_ws.queues import QueueState

from .advisory import (
    apply_donation,
    donated_cost,
    psum,
    reduce_advisory,
    ring_allgather,
)
from .partition import _cdiv, expert_shard, local_pool_state, route_local_pool_torch
from .steal import (
    StealPlan,
    deliver_home,
    plan_steals_all,
    send_stolen_shards,
    steal_pairs,
    steal_queue_state,
)

MESH_AXIS = "model"

#: telemetry row layout of one device's dispatch step ([D, len] output)
TELE_FIELDS = (
    "phase1_clock",   # local balanced-drain makespan
    "phase2_clock",   # own-continue makespan
    "steal_clock",    # stolen-segment makespan
    "advisory",       # exchanged load summary (post phase 1)
    "victim",         # chosen victim id (0 when no steal)
    "stole",          # 1 iff this device pulled a remote segment
    "take_tiles",     # tiles stolen by this device
    "mult_sum",       # Σ own-pool multiplicity (own + delivered stolen)
)


def phase_rounds(n_routed: int, bt: int, n_programs: int, n_devices: int) -> tuple[int, int]:
    """Static round budgets.  Phase 1 is a deliberate *truncation* budget: a
    program that claims a tile of cost c stays busy c rounds and a claim in
    the last round overruns by up to ``bt`` rows, so ``r1`` rounds retire
    about ``(r1 + bt) * P`` rows a device, the balanced 1/D share.  An
    overloaded device stops with its surplus queued, the others drain dry,
    and the exchange sends the idle devices to the surplus.  Phase 2 keeps
    the single-device bound (``expert_rounds_bound``'s Graham form), which
    drains any residue however phase 1 was cut."""
    r1 = max(1, _cdiv(n_routed, n_devices * n_programs) - bt + 1)
    r2 = _cdiv(n_routed, n_programs) + bt
    return r1, r2


def _pair_combine_part(routed, out_total, mult_total, *, bt: int):
    """Divide a device's rows by their tile's count (``mult_total``: the
    executions in lockstep, the writers in free mode) and scatter them to
    (token, choice) pair slots ``[Tk + 1, d]``; slot Tk is sacrificial (pads
    and foreign rows land there, then it is zeroed).  Each live pair slot is
    filled by exactly one device, so the cross-device sum of the parts is
    exact and the final reduction can be the oracle's expression."""
    pool_tiles = mult_total.shape[0]
    Tk = routed.n_routed
    dev = out_total.device
    starts = torch.arange(pool_tiles, device=dev) * bt
    div = divisor_from_tiles(starts, bt, mult_total, routed.n_rows)
    yr = out_total / div[:, None]
    src = torch.clamp(routed.row_src, max=Tk).long()
    part = torch.zeros((Tk + 1, out_total.shape[-1]), dtype=torch.float32, device=dev)
    part[src] = yr
    part[Tk] = 0.0
    return part


def _combine_pairs(y_pairs, gates):
    """The oracle's combine: ``(gates * pairs).sum(choice)``."""
    T, k = gates.shape
    d = y_pairs.shape[-1]
    return (gates.float()[:, :, None] * y_pairs[:T * k].reshape(T, k, d)).sum(dim=1)


def _wrote(mult):
    """1 where a launch wrote the tile (free mode's contribution count)."""
    return (mult > 0).to(torch.int32)


def _check_mode(mode):
    if mode not in (None,) + MODES:
        raise ValueError(f"mode must be None or one of {MODES}: {mode!r}")
    return mode in (None, "free")


def _check_covered(put, mult_total, me: int) -> None:
    """Every live tile of the device's pool ran at least once (one host
    read): the pool's live tiles are the prefix ``[0, Σtail)``."""
    n_live = int(put.tail.sum())
    missing = int((mult_total[:n_live] == 0).sum())
    if missing:
        raise RuntimeError(f"mesh dispatch on device {me}: {missing}/{n_live} live tiles "
                           "never executed (round budget too small?)")


class _Launch:
    """The launch keywords every phase shares."""

    def __init__(self, x, bt, n_programs, mode):
        self.x, self.bt, self.P, self.mode = x, bt, n_programs, mode
        self.free = _check_mode(mode)

    def __call__(self, state, tok_idx, wg, wu, wd, *, rounds, budget=False, **kw):
        # lockstep reads ``rounds`` as its rounds; free mode ignores it unless
        # the launch is the traced instantiation (``budget``), which reads it
        # as each program's budget in tile-slots
        if self.free and not budget:
            rounds = None
        return run_moe_schedule(state, self.x, tok_idx, wg, wu, wd, bt=self.bt, steal=True,
                                steal_policy="cost", rounds=rounds, mode=self.mode,
                                trace=self.free and budget, **kw)


def mesh_dispatch_body(x_flat, idx, gates, wg, wu, wd, *, n_experts: int, n_devices: int,
                       bt: int, n_programs: int, alpha: int = 1, steal: bool = True,
                       axis=MESH_AXIS, mode: Optional[str] = None):
    """One rank's dispatch step (the reference's ``shard_map`` body).

    Replicated inputs: ``x_flat [T, d]``, ``idx [T, k]``, ``gates [T, k]``
    on the rank's device.  This rank's shard of the expert dim: ``wg/wu
    [El, d, f]``, ``wd [El, f, d]`` (fp32 or bf16; sent to a thief in their
    own dtype).  ``axis`` is the mesh axis (an :class:`~repro_torch.launch.mesh.
    Axis`, or a name of the default group).  Returns the replicated
    combined rows ``[T, d]`` fp32 and this rank's telemetry row ``[1,
    len(TELE_FIELDS)]`` int32, after checking that every live tile of the
    rank's pool ran.

    ``steal=False`` is the per-device-static baseline: one launch to the
    full single-device bound, no advisory or steal traffic.
    """
    ax = resolve_axis(axis)
    if ax.size != n_devices:
        raise ValueError(f"axis {ax.name!r} has {ax.size} ranks, not {n_devices}")
    El = expert_shard(n_experts, n_devices)
    if wg.shape[0] != El:
        raise ValueError(f"rank {ax.index} holds {wg.shape[0]} experts, not its shard of {El}")
    me = ax.index
    T, k = idx.shape
    Tk = T * k
    xf = x_flat.float().contiguous()
    launch = _Launch(xf, bt, n_programs, mode)
    r1, r2 = phase_rounds(Tk, bt, n_programs, n_devices)

    put = route_local_pool_torch(idx, gates, n_experts, me * El, El, bt)
    tok = put.routed.tok_idx
    pool_tiles = put.records.shape[0]
    state = local_pool_state(put, n_programs)
    zero = torch.zeros((), dtype=torch.int32, device=xf.device)

    if not steal:
        res = launch(state, tok, wg, wu, wd, rounds=r2)
        _check_covered(put, res.mult, me)
        div = _wrote(res.mult) if launch.free else res.mult
        part = _pair_combine_part(put.routed, res.out, div, bt=bt)
        y = _combine_pairs(psum(part, ax), gates)
        tele = torch.stack([res.clock.max(), zero, zero, reduce_advisory(res.remaining), zero,
                            zero, zero, res.mult.sum(dtype=torch.int32)])
        return y, tele[None].to(torch.int32)

    # ---- phase 1: balanced local drain ---------------------------------------
    res1 = launch(state, tok, wg, wu, wd, rounds=r1, budget=True)

    # ---- advisory exchange + victim-context gather (a few KB) -----------------
    adv_self = reduce_advisory(res1.remaining)
    adv = ring_allgather(adv_self, ax, n_devices).reshape(n_devices)
    g_rec = ring_allgather(put.records, ax, n_devices)
    g_head = ring_allgather(res1.head, ax, n_devices)
    g_tail = ring_allgather(put.tail, ax, n_devices)
    g_toff = ring_allgather(put.toff[:El + 1].contiguous(), ax, n_devices)
    g_tok = ring_allgather(tok, ax, n_devices)

    # ---- replicated steal plan + coalesced donation advisory ------------------
    plans = plan_steals_all(adv, g_head, g_tail, n_devices=n_devices, bt=bt, alpha=alpha)
    plan = plans[me]
    rem2 = apply_donation(res1.remaining, donated_cost(put, plan.new_tail))

    # ---- weight shards: victim to thief only, nothing when no rank steals -----
    stolen = send_stolen_shards((wg, wu, wd), steal_pairs(plans), ax)

    # ---- phase 2a: continue the own pool to the cut tails ---------------------
    state2 = QueueState(tasks=put.records, head=res1.head, tail=plan.new_tail,
                        local_head=res1.local_head, taken=res1.taken, task_list=None,
                        n_tasks_hint=pool_tiles, remaining=rem2, pool_off=put.toff[:El + 1])
    res2 = launch(state2, tok, wg, wu, wd, rounds=r2, out=res1.out, mult=res1.mult)

    # ---- phase 2b: run the stolen remote segment ------------------------------
    # (a non-thief's launch has an empty segment and runs no tile: it is
    # given its own shard)
    v = int(plan.victim)
    state_s = steal_queue_state(g_rec, g_toff, plan, n_programs=n_programs,
                                pool_tiles=pool_tiles, bt=bt, victim=v)
    res_s = launch(state_s, g_tok[v], *(stolen or (wg, wu, wd)), rounds=r2)
    del stolen

    # ---- deliver stolen contributions home, merge the counts ------------------
    out_in, mult_in, wrote_in = deliver_home(res_s.out, res_s.mult, plan, ax,
                                             n_devices=n_devices, me=me)
    out_total = res2.out + out_in
    mult_total = res2.mult + mult_in
    _check_covered(put, mult_total, me)
    div = _wrote(res2.mult) + wrote_in if launch.free else mult_total

    # ---- count-normalised pair combine ----------------------------------------
    part = _pair_combine_part(put.routed, out_total, div, bt=bt)
    y = _combine_pairs(psum(part, ax), gates)
    tele = torch.stack([res1.clock.max(), res2.clock.max(), res_s.clock.max(), adv_self,
                        plan.victim, plan.stole.to(torch.int32), plan.take_tiles,
                        mult_total.sum(dtype=torch.int32)])
    return y, tele[None].to(torch.int32)


def mesh_wstrace(tele, *, collective_bytes=None):
    """Lift a ``[D, len(TELE_FIELDS)]`` telemetry block into a
    :class:`~repro_torch.wstrace.trace.WSTrace` carrying per-device *phase*
    counters (``mesh_phases``) instead of per-extraction events; the
    Perfetto exporter renders one track a device with phase slices,
    remote-steal flow arrows (victim → thief) and advisory /
    collective-bytes counters.  ``collective_bytes`` (a device, e.g.
    :func:`~repro_torch.mesh_ws.advisory.exchange_payload_bytes`) is
    attached to every device's counters when given."""
    from repro_torch.wstrace.ring import EVENT_WIDTH
    from repro_torch.wstrace.trace import WSTrace

    if isinstance(tele, torch.Tensor):
        tele = tele.cpu().numpy()
    tele = np.asarray(tele)
    D = tele.shape[0]
    phases = []
    for dev in range(D):
        row = {name: int(tele[dev, i]) for i, name in enumerate(TELE_FIELDS)}
        if collective_bytes is not None:
            row["collective_bytes"] = int(collective_bytes)
        phases.append(row)
    # a device's wall: phase 1, then the longer of own-continue / steal
    span = tele[:, 0] + np.maximum(tele[:, 1], tele[:, 2])
    return WSTrace(events=np.zeros((0, EVENT_WIDTH), np.int32), n_programs=D, n_queues=D,
                   makespan=int(span.max(initial=0)), dropped=np.zeros(D, np.int64),
                   queue_loads=None, mesh_phases=phases)


def expert_ffn_mesh_ws(idx, gates, x, wg, wu, wd, *, mesh, bt: int = 8, n_programs: int = 2,
                       alpha: int = 1, steal: bool = True, axis: str = MESH_AXIS,
                       mode: Optional[str] = None, return_telemetry: bool = False):
    """Router-free mesh twin of :func:`~repro_torch.moe_ws.expert_ffn_nodrop_ref`:
    the same argument order and ``[T, d]`` fp32 return, the expert dim
    split over ``mesh``'s ``axis``.  Every rank calls it with the same
    routing and ``x`` and with its own shard of the weights: ``wg/wu [E/D,
    d, f]``, ``wd [E/D, f, d]``, the experts ``[index·E/D, (index+1)·E/D)``
    of a global ``E``.  ``return_telemetry`` adds the ``[D,
    len(TELE_FIELDS)]`` telemetry of every rank (one more sum)."""
    ax = mesh.axis(axis)
    D = mesh.shape[axis]
    E = wg.shape[0] * D
    dev = x.device
    idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int32)
    gates = torch.as_tensor(gates).to(device=dev, dtype=torch.float32)
    y, tele = mesh_dispatch_body(x, idx, gates, wg, wu, wd, n_experts=E, n_devices=D, bt=bt,
                                 n_programs=n_programs, alpha=alpha, steal=steal, axis=ax,
                                 mode=mode)
    if not return_telemetry:
        return y
    box = torch.zeros((D, len(TELE_FIELDS)), dtype=torch.int32, device=dev)
    box[ax.index] = tele[0]
    return y, psum(box, ax)


def moe_ffn_mesh_ws(x, p, cfg, group_size: int = 1024, *, mesh=None, bt: int = 8,
                    n_programs: int = 2, alpha: int = 1, mode: Optional[str] = None):
    """x: [B, S, d] -> (y, aux_loss): the ``moe_ffn`` drop-in with the
    dropless dispatch split over a mesh (``cfg.moe_dispatch="mesh-ws"``).

    The router, shared experts and aux loss are ``moe_ffn_ws``'s; the routed
    experts run the two-level cross-device scheduler.  ``mesh=None`` builds
    :func:`~repro_torch.launch.mesh.make_expert_mesh` over the default
    process group's ranks (1 device without one: the same code path, no
    remote victims).  ``mode`` is the kernels' (free by default).
    Forward-only: a call that autograd records raises, and training
    refuses the dispatch (``launch.steps``)."""
    from repro_torch.launch.mesh import make_expert_mesh
    from repro_torch.moe_ws.layer import _router, _shared_experts

    wg, wu, wd = p["we_g"], p["we_u"], p["we_d"]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wg, wu, wd)):
        raise ValueError("moe_dispatch='mesh-ws' is forward-only; run it under "
                         "torch.no_grad() (training takes 'ws')")
    if mesh is None:
        mesh = make_expert_mesh(cfg.n_experts)
    El = expert_shard(cfg.n_experts, mesh.shape[MESH_AXIS])
    sl = slice(mesh.axis(MESH_AXIS).index * El, (mesh.axis(MESH_AXIS).index + 1) * El)
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    _, gate_vals, idx, aux = _router(x_flat, p, cfg, group_size)
    y = expert_ffn_mesh_ws(idx, gate_vals, x_flat, wg[sl], wu[sl], wd[sl], mesh=mesh, bt=bt,
                           n_programs=n_programs, alpha=alpha, mode=mode)
    if cfg.n_shared_experts:
        y = y + _shared_experts(x_flat, p).float()
    return y.to(x.dtype).reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# one-process emulation: the same protocol with every collective replaced by
# stacking; the adversarial drills drive it


class EmulatedDispatch(NamedTuple):
    y: torch.Tensor       # [T, d] combined rows
    plans: tuple          # per-device StealPlan actually applied
    adv: torch.Tensor     # [D] exchanged advisories (before any override)
    mult_total: tuple     # per-device merged multiplicity
    clocks: tuple         # per-device (c1, c2, cs) makespans
    tails: tuple          # per-device live tile counts [El]
    writers: tuple        # per-device count of devices whose launches wrote each tile


def emulate_mesh_dispatch(x_flat, idx, gates, wg, wu, wd, *, n_devices: int, bt: int = 8,
                          n_programs: int = 2, alpha: int = 1, adv_override=None,
                          plans_override: Optional[Sequence[StealPlan]] = None,
                          mode: Optional[str] = None) -> EmulatedDispatch:
    """Run the mesh protocol in one process, the devices a Python loop and
    every collective replaced by its stacked equivalent (weights in their
    own dtype, on ``x_flat``'s device).

    The numerics are the ranks': each delivery sum has at most one nonzero
    contributor a slot in a clean plan, so the emulated and the rank
    outputs agree bit for bit.  Two adversarial hooks force what a live
    mesh cannot be forced into deterministically:

    * ``adv_override [D]`` replaces the exchanged advisories: stale or
      corrupt summaries may mis-rank victims but must not break the answer;
    * ``plans_override`` replaces the replicated plan: segments may overlap
      the victim's retained prefix or each other, forcing cross-device
      duplicates that only the count normalisation absorbs.

    Only thieves launch the stolen segment (the ranks' non-thief launch is
    a no-op).  No coverage check: an adversarial plan may drop tiles, and
    the drills check what they expect."""
    dev = x_flat.device
    E = wg.shape[0]
    El = expert_shard(E, n_devices)
    idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int32)
    gates = torch.as_tensor(gates).to(device=dev, dtype=torch.float32)
    T, k = idx.shape
    Tk = T * k
    xf = x_flat.float().contiguous()
    launch = _Launch(xf, bt, n_programs, mode)
    r1, r2 = phase_rounds(Tk, bt, n_programs, n_devices)

    def shard(m, w):
        return w[m * El:(m + 1) * El]

    puts, res1s = [], []
    for m in range(n_devices):
        put = route_local_pool_torch(idx, gates, E, m * El, El, bt)
        res1 = launch(local_pool_state(put, n_programs), put.routed.tok_idx, shard(m, wg),
                      shard(m, wu), shard(m, wd), rounds=r1, budget=True)
        puts.append(put)
        res1s.append(res1)
    pool_tiles = puts[0].records.shape[0]

    adv = torch.stack([reduce_advisory(r.remaining) for r in res1s])
    g_head = torch.stack([r.head for r in res1s])
    g_tail = torch.stack([p.tail for p in puts])
    g_rec = torch.stack([p.records for p in puts])
    g_toff = torch.stack([p.toff[:El + 1] for p in puts])
    adv_eff = adv if adv_override is None else torch.as_tensor(adv_override).to(
        device=dev, dtype=torch.int32)
    if plans_override is not None:
        plans = list(plans_override)
    else:
        plans = plan_steals_all(adv_eff, g_head, g_tail, n_devices=n_devices, bt=bt,
                                alpha=alpha)

    out_in = [torch.zeros_like(r.out) for r in res1s]
    mult_in = [torch.zeros_like(r.mult) for r in res1s]
    wrote_in = [torch.zeros_like(r.mult) for r in res1s]
    res2s, cs = [], []
    for m in range(n_devices):
        put, res1, plan = puts[m], res1s[m], plans[m]
        rem2 = apply_donation(res1.remaining, donated_cost(put, plan.new_tail))
        state2 = QueueState(tasks=put.records, head=res1.head, tail=plan.new_tail,
                            local_head=res1.local_head, taken=res1.taken, task_list=None,
                            n_tasks_hint=pool_tiles, remaining=rem2,
                            pool_off=put.toff[:El + 1])
        res2s.append(launch(state2, put.routed.tok_idx, shard(m, wg), shard(m, wu),
                            shard(m, wd), rounds=r2, out=res1.out, mult=res1.mult))
        if not bool(plan.stole):
            cs.append(0)
            continue
        v = int(plan.victim)
        state_s = steal_queue_state(g_rec, g_toff, plan, n_programs=n_programs,
                                    pool_tiles=pool_tiles, bt=bt, victim=v)
        res_s = launch(state_s, puts[v].routed.tok_idx, shard(v, wg), shard(v, wu),
                       shard(v, wd), rounds=r2)
        cs.append(int(res_s.clock.max()))
        out_in[v] = out_in[v] + res_s.out
        mult_in[v] = mult_in[v] + res_s.mult
        wrote_in[v] = wrote_in[v] + _wrote(res_s.mult)

    pairs = torch.zeros((Tk + 1, xf.shape[-1]), dtype=torch.float32, device=dev)
    mult_total, writers, clocks = [], [], []
    for m in range(n_devices):
        out_t = res2s[m].out + out_in[m]
        mult_t = res2s[m].mult + mult_in[m]
        wrote_t = _wrote(res2s[m].mult) + wrote_in[m]
        mult_total.append(mult_t)
        writers.append(wrote_t)
        pairs = pairs + _pair_combine_part(puts[m].routed, out_t,
                                           wrote_t if launch.free else mult_t, bt=bt)
        clocks.append((int(res1s[m].clock.max()), int(res2s[m].clock.max()), cs[m]))
    y = _combine_pairs(pairs, gates)
    return EmulatedDispatch(y=y, plans=tuple(plans), adv=adv, mult_total=tuple(mult_total),
                            clocks=tuple(clocks), tails=tuple(p.tail for p in puts),
                            writers=tuple(writers))
