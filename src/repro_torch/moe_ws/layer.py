"""``moe_ffn_ws``: dropless MoE FFN on the fence-free work-stealing tile
scheduler, forward and backward (port of ``repro/moe_ws/layer.py``).

Drop-in for :func:`repro_torch.models.moe.moe_ffn` (same ``(y, aux_loss)``
return, same router math) with the capacity-dropping dispatch replaced by
expert-tile tasks through the expert megakernel:

* router top-k → per-expert owner queues: every routed (token, expert) pair
  gets a task row; nothing is dropped.  Two Puts: the host Put
  (``dispatch.route_to_tasks``, compact per-expert queues) and the
  shared-pool Put (``dispatch.route_to_tasks_pool``);
* programs Take their own expert's tiles and Steal from overloaded experts'
  stale head views (plain loads and stores only);
* the combine divides each routed row by its tile's execution count in
  lockstep mode (a free-mode ``out`` is already normalised), then sums
  ``gate × row`` into each token in row order (``combine_routed``), plain
  torch, as the reference computes it outside Pallas.

**Differentiable.**  The routed-expert core is a ``torch.autograd.Function``
(the reference's ``jax.custom_vjp``) whose backward is the closed-form
transpose of :func:`expert_ffn_nodrop_ref`, the no-drop function the
scheduler computes whatever its schedule.  Its residuals are the core's
inputs ``(x_flat, idx, gate_vals, wg, wu, wd)`` only; the backward
re-derives the routing with the pool Put.  ``grad_dispatch="dense"``
evaluates the transpose over the routed pairs grouped by expert;
``"ws"`` re-schedules its per-row tiles through a second launch on the
pool layout (``csrc/ws_expert_grad.cu``).  The per-expert weight grads are
``torch.matmul`` segment sums over each expert's contiguous rows (the
reference leaves them to XLA outside Pallas) and ``dx`` is an
``index_add_``.  Router gates and the aux loss stay outside the Function,
so their gradients flow through the ordinary torch router math.

The reference picks the pool layout when it is traced (its jitted train
step and decode step) and the host Put eagerly.  The port is eager
everywhere, so ``queue_layout=None`` takes autograd recording the call, or
a ``drain`` counter (the device-Put decode step, as
:func:`repro_torch.serving.engine.jit_decode_step_ws` captures it), as the
sign of a traced caller: the pool layout then, the host Put otherwise.  A
``drain`` counter selects the reference's traced branch: the pool
(:func:`~.dispatch.route_to_tasks_pool_torch`) or padded
(:func:`~.dispatch.route_to_tasks_torch`) Put built on the routing's device,
the static rounds bound, the combine on the device, and the drain check
added to the counter for its caller to read once a step.

``steal_run_cap > 1`` (half-run steals, cost policy) reaches the forward
launch on both layouts and the ws backward's launch, with the rounds bound's
``cap · bt`` tail; the static schedule has no thieves and ignores it, as in
the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.pallas_ws.kernel import DrainCounter
from repro_torch.pallas_ws.queues import (
    make_pool_queue_state,
    make_queue_state,
    make_queue_state_torch,
)
from repro_torch.pallas_ws.ragged import RaggedStats as DispatchStats  # family-neutral

from .dispatch import (
    divisor_from_tiles,
    expert_queue_candidates,
    expert_rounds_bound,
    route_to_tasks,
    route_to_tasks_pool,
    route_to_tasks_pool_torch,
    route_to_tasks_torch,
    row_divisor,
)
from .expert_kernel import dsilu, run_moe_grad_schedule, run_moe_schedule

SCHEDULES = ("ws", "static")
QUEUE_LAYOUTS = ("pool", "padded")
GRAD_DISPATCHES = ("dense", "ws")


def _router(x_flat, p, cfg, group_size: int):
    """The dense path's router (``models.moe.router_topk``), reshaped to flat
    [T, ...] views."""
    from repro_torch.models.fsdp import moe_group
    from repro_torch.models.moe import router_topk

    T, d = x_flat.shape
    g = moe_group(T, group_size)
    G = T // g
    if G * g != T:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    probs, gate_vals, idx, aux = router_topk(x_flat.reshape(G, g, d), p, cfg)
    k = cfg.top_k
    return (probs.reshape(T, cfg.n_experts), gate_vals.reshape(T, k),
            idx.reshape(T, k), aux)


def _shared_experts(x_flat, p):
    hs = F.silu(torch.einsum("td,df->tf", x_flat, p["ws_g"]))
    hs = hs * torch.einsum("td,df->tf", x_flat, p["ws_u"])
    return torch.einsum("tf,fd->td", hs, p["ws_d"])


def _check_drained(state, res) -> None:
    # pool layout: the live slots are exactly the pool prefix [0, sum(tail))
    n_live = int(np.asarray(state.tail).sum()) if state.pool else state.n_tasks
    if n_live and not bool((res.mult[:n_live] >= 1).all()):
        missing = int((res.mult[:n_live] == 0).sum())
        raise RuntimeError(f"expert scheduler under-provisioned: {missing}/{n_live} "
                           "tiles never executed (rounds bound too small?)")


def _row_divisor(routed, tasks, res, bt: int):
    """Per-row multiplicity divisor of a lockstep launch: from the host task
    list, or (``tasks=None``, the pool and padded device layouts) from the
    uniform tiles, tile ``t`` owning rows ``[t·bt, (t+1)·bt)``, on the
    device."""
    if tasks is None:
        n_tiles = res.mult.shape[0]
        return divisor_from_tiles(torch.arange(n_tiles, device=res.mult.device) * bt, bt,
                                  res.mult, routed.n_rows)
    return torch.from_numpy(row_divisor(tasks, res.mult.cpu().numpy(), routed.n_rows))


def _normalised(res, routed, tasks, bt: int):
    """A launch's per-row output divided by its tile multiplicity (lockstep)
    or as stored (free)."""
    out = res.out
    if res.mode == "lockstep":
        out = out / _row_divisor(routed, tasks, res, bt).to(out.device)[:, None]
    return out


def _on(a, dev, dtype):
    """A routed array (numpy or a tensor) as a ``dtype`` tensor on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


def combine_routed(routed, tasks, res, *, bt: Optional[int] = None):
    """Multiplicity-normalised, gate-weighted combine of an expert-kernel run:
    a lockstep ``out`` is divided row by row by its tile's execution count
    (a free-mode ``out`` holds plain stores and is used as it is), then each
    token sums ``gate × row`` over its routed rows.  Returns [n_tokens, d]
    float32 on ``res.out``'s device.

    The sum runs over each token's rows in increasing row order, one add at
    a time: the order of a sequential scatter-add (``index_add_`` on the
    CPU), on any device.  So the result does not depend on the order atomic
    adds land in, and every expert-major layout (the host Put, the padded
    and pool device Puts) gives the same bits.  Pad rows (``row_src ==
    n_routed``) join no token; a pair with no row adds 0.

    ``tasks`` is the host task list; pass ``tasks=None`` with the tile
    height ``bt`` for the pool and padded device layouts.
    """
    if tasks is None and bt is None:
        raise ValueError("the pool layout's combine needs the tile height bt")
    out = _normalised(res, routed, tasks, bt)
    dev = out.device
    T, Tk = routed.n_tokens, routed.n_routed
    n_rows, d = out.shape
    # each row's part, and a zero row for a pair the layout dropped
    part = torch.cat([_on(routed.gates, dev, torch.float32)[:, None] * out,
                      out.new_zeros((1, d))])
    # the row of each (token, choice) pair; every pad row lands on slot Tk
    row_of = torch.full((Tk + 1,), n_rows, dtype=torch.int64, device=dev)
    row_of[_on(routed.row_src, dev, torch.int64)] = torch.arange(n_rows, device=dev)
    rows = row_of[:Tk].reshape(T, Tk // T).sort(dim=1).values
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(rows.shape[1]):
        y = y + part[rows[:, j]]
    return y


def expert_ffn_nodrop_ref(idx, gates, x, wg, wu, wd):
    """Raw-weight O(T·E) no-drop oracle: every expert's gated FFN applied to
    every token, combined with the routed gates.  ``x``: [T, d]; returns
    [T, d] float32."""
    xf = x.float()
    h = F.silu(torch.einsum("td,edf->tef", xf, wg.float()))
    h = h * torch.einsum("td,edf->tef", xf, wu.float())
    y_all = torch.einsum("tef,efd->ted", h, wd.float())
    idx = torch.as_tensor(idx, dtype=torch.int64, device=x.device)
    y_sel = torch.take_along_dim(y_all, idx[:, :, None], dim=1)
    gates = torch.as_tensor(gates, dtype=torch.float32, device=x.device)
    return (gates[:, :, None] * y_sel).sum(dim=1)


class _CoreStatic(NamedTuple):
    """Launch configuration of the routed-expert core (no tensors)."""

    schedule: str
    steal_policy: str
    steal_run_cap: int      # half-run cap of the stealing launches
    queue_layout: str       # resolved: "pool" or "padded"
    grad_dispatch: str
    n_programs: int
    bt: int
    mode: Optional[str]


def _pool_put(idx, gate_vals, n_experts: int, n_programs: int, bt: int,
              steal_run_cap: int = 1):
    """The shared-pool Put of a routing and its lockstep rounds bound."""
    T, k = idx.shape
    records, tail, pool_off, routed = route_to_tasks_pool(
        idx.cpu().numpy(), gate_vals.detach().float().cpu().numpy(), n_experts, bt=bt)
    state = make_pool_queue_state(records, tail, pool_off, routed.loads, n_programs,
                                  n_tasks=records.shape[0])
    return state, routed, expert_rounds_bound(T * k, bt, n_experts, n_programs, True,
                                              steal_run_cap=steal_run_cap)


def _device_put(static: _CoreStatic, idx, gate_vals, E: int, P: int):
    """The traced branch's Put, built on ``idx``'s device: the shared pool
    with stealing (``queue_layout="pool"``), else the padded layout over
    ``E`` queues (stealing) or ``P`` (the static baseline).  Returns
    ``(state, routed, live)``, ``live`` the [n_tasks] mask of live tile ids
    for the drain check."""
    bt = static.bt
    gates = gate_vals.detach().float()
    if static.queue_layout == "pool":
        records, tail, pool_off, routed = route_to_tasks_pool_torch(idx, gates, E, bt=bt)
        state = make_pool_queue_state(records, tail, pool_off, routed.loads, P,
                                      n_tasks=records.shape[0])
        n = records.shape[0]
        live = torch.arange(n, device=records.device) < tail.sum()
        return state, routed, live
    records, live, routed = route_to_tasks_torch(idx, gates, E, bt=bt)
    n_queues = E if static.schedule == "ws" else P
    cand, cand_live = expert_queue_candidates(records, live, n_queues)
    state = make_queue_state_torch(cand, cand_live, P,
                                   n_tasks=records.shape[0] * records.shape[1])
    return state, routed, live.reshape(-1)


def _dispatch_and_run(static: _CoreStatic, x_flat, idx, gate_vals, wg, wu, wd,
                      trace: bool = False, drain: Optional[DrainCounter] = None):
    """Put + megakernel launch + combine.  Returns ``(y [T, d] f32, state,
    res)``; ``trace`` records the launch's event rings.  With ``drain`` the
    Put is built on the device and the launch's unexecuted live tiles are
    added to it (the caller reads it); otherwise the launch is checked at
    once."""
    E, bt, P = wg.shape[0], static.bt, static.n_programs
    # With stealing every expert gets its own queue; the static baseline
    # needs every queue owned by a program, so experts are placed
    # round-robin over programs (classic expert parallelism).
    steal = static.schedule == "ws"
    cap = static.steal_run_cap if steal else 1
    free = static.mode in (None, "free")
    if drain is not None:
        T, k = idx.shape
        state, routed, live = _device_put(static, idx, gate_vals, E, P)
        rounds = expert_rounds_bound(T * k, bt, state.n_queues, P, steal, steal_run_cap=cap)
        res = run_moe_schedule(state, x_flat, routed.tok_idx, wg, wu, wd, bt=bt, steal=steal,
                               steal_policy=static.steal_policy, steal_run_cap=cap,
                               rounds=None if free else rounds, mode=static.mode)
        drain.add(res.mult, live)
        return combine_routed(routed, None, res, bt=bt), state, res
    if static.queue_layout == "pool":
        state, routed, rounds = _pool_put(idx, gate_vals, E, P, bt, cap)
        tasks = None
    else:
        tasks, routed = route_to_tasks(idx.cpu().numpy(),
                                       gate_vals.detach().float().cpu().numpy(), E, bt=bt)
        state = make_queue_state(tasks, P, n_queues=E if steal else P, partition="owner")
        rounds = None
    # rounds is a lockstep bound; a traced free launch would read it as a budget
    res = run_moe_schedule(state, x_flat, routed.tok_idx, wg, wu, wd, bt=bt, steal=steal,
                           steal_policy=static.steal_policy, steal_run_cap=cap,
                           rounds=None if free else rounds, mode=static.mode, trace=trace)
    _check_drained(state, res)
    return combine_routed(routed, tasks, res, bt=bt), state, res


def _expert_weight_grads(expert_off, loads, xr, du, dv, h, dy, like):
    """Per-expert weight grads as segment sums over each expert's contiguous
    rows: ``dwg[e] = xr[seg]ᵀ du[seg]``, ``dwu[e] = xr[seg]ᵀ dv[seg]``,
    ``dwd[e] = h[seg]ᵀ dy[seg]``, fp32 products written straight into
    tensors of the weights' dtype (no [rows, d, f] outer products and no
    fp32 copy of the weights' size)."""
    wg, wu, wd = like
    dwg, dwu, dwd = (torch.zeros_like(w) for w in (wg, wu, wd))
    for e in np.flatnonzero(np.asarray(loads) > 0):
        seg = slice(int(expert_off[e]), int(expert_off[e]) + int(loads[e]))
        xs = xr[seg].T
        dwg[e] = (xs @ du[seg]).to(dwg.dtype)
        dwu[e] = (xs @ dv[seg]).to(dwu.dtype)
        dwd[e] = (h[seg].T @ dy[seg]).to(dwd.dtype)
    return dwg, dwu, dwd


def _grad_dense(x_flat, idx, gate_vals, wg, wu, wd, gy):
    """Closed-form VJP of the no-drop routed-expert function evaluated over
    the flat [T·k] pair list grouped by expert (no scheduler, no pads):
    per-expert fp32 products, ``dx`` by ``index_add_``.  Returns ``(dx
    [T, d], dgates [T, k], dwg, dwu, dwd)``, dx and dgates in fp32."""
    T, d = x_flat.shape
    k = idx.shape[1]
    dev = x_flat.device
    fe = idx.reshape(-1).long()
    ft = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(fe, stable=True)
    fe_s, ft_s = fe[order], ft[order]
    loads = torch.bincount(fe_s, minlength=wg.shape[0]).cpu().numpy()
    off = np.concatenate([[0], np.cumsum(loads)])
    xr = x_flat.float()[ft_s]                             # [Tk, d], grouped by expert
    ct = gy[ft_s]
    gr = gate_vals.reshape(-1).float()[order]
    n, f = xr.shape[0], wg.shape[-1]
    u, v = (torch.zeros((n, f), device=dev) for _ in range(2))
    yhat_dot = torch.zeros(n, device=dev)
    dxr = torch.zeros((n, d), device=dev)
    dh = torch.zeros((n, f), device=dev)
    for e in np.flatnonzero(loads > 0):
        seg = slice(int(off[e]), int(off[e + 1]))
        wge, wue, wde = wg[e].float(), wu[e].float(), wd[e].float()
        u[seg], v[seg] = xr[seg] @ wge, xr[seg] @ wue
        sig = torch.sigmoid(u[seg])
        h_e = u[seg] * sig * v[seg]
        yhat_dot[seg] = (ct[seg] * (h_e @ wde)).sum(-1)
        dh[seg] = (gr[seg, None] * ct[seg]) @ wde.T
    sig = torch.sigmoid(u)
    s = u * sig
    h = s * v
    dv = dh * s
    du = dh * v * dsilu(u, sig)
    for e in np.flatnonzero(loads > 0):
        seg = slice(int(off[e]), int(off[e + 1]))
        dxr[seg] = du[seg] @ wg[e].float().T + dv[seg] @ wu[e].float().T
    dx = torch.zeros((T, d), device=dev).index_add_(0, ft_s, dxr)
    dgates = torch.zeros(T * k, device=dev)
    dgates[order] = yhat_dot
    dwg, dwu, dwd = _expert_weight_grads(off[:-1], loads, xr, du, dv, h,
                                         gr[:, None] * ct, (wg, wu, wd))
    return dx, dgates.reshape(T, k), dwg, dwu, dwd


def _grad_ws(static: _CoreStatic, x_flat, idx, gate_vals, wg, wu, wd, gy):
    """The same transpose with its per-row tiles re-scheduled through a
    second launch on the shared-pool layout (``run_moe_grad_schedule``):
    per-row outputs are disjoint across tiles, so duplicates are
    normalised like the forward's, and the weight-grad segment sums run on
    the normalised rows.  The routing is re-derived from ``(idx,
    gate_vals)`` by the pool Put."""
    E, bt, P = wg.shape[0], static.bt, static.n_programs
    state, routed, rounds = _pool_put(idx, gate_vals, E, P, bt, static.steal_run_cap)
    res = run_moe_grad_schedule(state, x_flat, gy, routed.tok_idx, routed.gates, wg, wu,
                                wd, bt=bt, steal=True, steal_policy=static.steal_policy,
                                steal_run_cap=static.steal_run_cap, rounds=rounds,
                                mode=static.mode)
    # an unexecuted grad tile would give exactly-zero gradients (the
    # divisor clamps at 1), so under-provisioning raises as in the forward
    _check_drained(state, res)
    return assemble_row_grads(res, routed, idx, x_flat, gy, bt=bt, weights=(wg, wu, wd))


def assemble_row_grads(res, routed, idx, x_flat, gy, *, bt: int, weights):
    """Normalise a grad launch's per-row block by the tile multiplicity
    (lockstep) and scatter it into the core's cotangents: ``dx`` by routed
    row → token (``index_add_``), ``dgates`` by row → (token, choice) via
    ``RoutedSet.row_src``, and the per-expert weight grads as segment sums
    over each expert's rows of the pool (:func:`_expert_weight_grads`).
    Public so the multiplicity drills can drive it on re-executed launches.
    Returns ``(dx [T, d], dgates [T, k], dwg, dwu, dwd)``."""
    T, k = idx.shape
    d, f = x_flat.shape[1], weights[0].shape[-1]
    G = _normalised(res, routed, None, bt)
    dev = G.device
    dxr, du, dv, h = G[:, :d], G[:, d:d + f], G[:, d + f:d + 2 * f], G[:, d + 2 * f:d + 3 * f]
    tok = torch.as_tensor(routed.tok_idx, dtype=torch.int64).to(dev)
    grow = torch.as_tensor(routed.gates, dtype=torch.float32).to(dev)
    src = torch.as_tensor(routed.row_src, dtype=torch.int64).to(dev)
    xr = x_flat.float()[tok]
    dy = grow[:, None] * gy[tok]                       # 0 on pad rows (gate 0)
    dx = torch.zeros((T, d), device=dev).index_add_(0, tok, dxr)
    # pad rows scatter their (zero) gate cotangent to the sacrificial slot T·k
    dgates = torch.zeros(T * k + 1, device=dev).index_add_(
        0, src.clamp(max=T * k), G[:, -1])[:T * k].reshape(T, k)
    dwg, dwu, dwd = _expert_weight_grads(routed.expert_off, routed.loads, xr, du, dv, h,
                                         dy, weights)
    return dx, dgates, dwg, dwu, dwd


class _MoECore(torch.autograd.Function):
    """The routed-expert core: forward on the expert megakernel, backward
    the closed-form transpose (``grad_dispatch``).  Residuals are the
    core's inputs only."""

    @staticmethod
    def forward(ctx, x_flat, gate_vals, wg, wu, wd, idx, static, drain):
        y, _, _ = _dispatch_and_run(static, x_flat, idx, gate_vals, wg, wu, wd, drain=drain)
        ctx.save_for_backward(x_flat, gate_vals, wg, wu, wd, idx)
        ctx.static = static
        return y

    @staticmethod
    def backward(ctx, gy):
        x_flat, gate_vals, wg, wu, wd, idx = ctx.saved_tensors
        gy = gy.float().contiguous()
        if ctx.static.grad_dispatch == "ws":
            grads = _grad_ws(ctx.static, x_flat, idx, gate_vals, wg, wu, wd, gy)
        else:
            grads = _grad_dense(x_flat, idx, gate_vals, wg, wu, wd, gy)
        dx, dgates, dwg, dwu, dwd = grads
        return (dx.to(x_flat.dtype), dgates.to(gate_vals.dtype), dwg, dwu, dwd, None, None,
                None)


def _check_knobs(schedule, queue_layout, grad_dispatch, trace, return_stats, drain):
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}: {schedule!r}")
    if queue_layout not in (None,) + QUEUE_LAYOUTS:
        raise ValueError(f"queue_layout must be None or one of {QUEUE_LAYOUTS}")
    if queue_layout == "pool" and schedule != "ws":
        raise ValueError("queue_layout='pool' needs per-expert queues (schedule='ws'); "
                         "the static baseline regroups experts onto program queues")
    if grad_dispatch not in GRAD_DISPATCHES:
        raise ValueError(f"grad_dispatch must be one of {GRAD_DISPATCHES}")
    if trace and not return_stats:
        raise ValueError("trace=True attaches the WSTrace to the stats; pass "
                         "return_stats=True as well")
    if drain is not None and return_stats:
        raise ValueError("return_stats reads the launch on the host: the device Put "
                         "(drain) has no host telemetry")


def moe_ffn_ws(x, p, cfg, group_size: int = 1024, *, schedule: str = "ws",
               steal_policy: str = "cost", steal_run_cap: int = 1,
               queue_layout: Optional[str] = None, grad_dispatch: str = "dense",
               n_programs: int = 8, bt: int = 8, mode: Optional[str] = None,
               return_stats: bool = False, trace: bool = False,
               drain: Optional[DrainCounter] = None):
    """x: [B, S, d] -> (y: [B, S, d], aux_loss scalar): the dropless ws
    dispatch, differentiable.

    ``schedule="ws"`` steals over per-expert queues; ``"static"`` drains
    owner queues only (experts round-robin over programs, same kernel).
    ``steal_policy`` is ``"cost"`` (own queue, then the argmax of the
    advisory) or ``"scan"``; ``steal_run_cap > 1`` (cost policy) lets one
    steal claim the victim's half-run of up to that many tiles.  ``bt`` is
    the tile height, ``n_programs`` the program count, ``mode`` the
    kernels' (``"free"`` by default, or ``"lockstep"``).  ``queue_layout``
    is ``"pool"`` or ``"padded"`` (the host Put); ``None`` picks the pool
    when autograd records the call and the schedule steals.
    ``grad_dispatch`` names the backward's evaluation: ``"dense"`` or
    ``"ws"`` (the grad megakernel).  ``return_stats``
    appends the forward launch's :class:`DispatchStats`; it has no backward,
    so a call that autograd records raises ``ValueError``.  ``trace=True``
    (with ``return_stats``) records the launch's event rings and attaches
    the decoded :class:`~repro_torch.wstrace.WSTrace` to the stats.
    ``drain`` (a :class:`~repro_torch.pallas_ws.kernel.DrainCounter`) takes
    the device Put, with no read back to the host: the launch's unexecuted
    live tiles are added to it, and its caller reads it.
    """
    _check_knobs(schedule, queue_layout, grad_dispatch, trace, return_stats, drain)
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    _, gate_vals, idx, aux = _router(x_flat, p, cfg, group_size)
    wg, wu, wd = p["we_g"], p["we_u"], p["we_d"]
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x_flat, gate_vals, wg, wu, wd))
    if recording and return_stats:
        raise ValueError("return_stats runs the forward launch alone and has no "
                         "backward; call it under torch.no_grad()")
    if queue_layout is None:
        traced = recording or drain is not None
        queue_layout = "pool" if (traced and schedule == "ws") else "padded"
    static = _CoreStatic(schedule=schedule, steal_policy=steal_policy,
                         steal_run_cap=int(steal_run_cap), queue_layout=queue_layout,
                         grad_dispatch=grad_dispatch, n_programs=n_programs, bt=bt, mode=mode)
    if return_stats:
        with torch.no_grad():
            y, state, res = _dispatch_and_run(static, x_flat, idx, gate_vals, wg, wu, wd,
                                              trace=trace)
    else:
        y = _MoECore.apply(x_flat, gate_vals, wg, wu, wd, idx, static, drain)
    if cfg.n_shared_experts:
        y = y + _shared_experts(x_flat, p).float()
    y = y.to(x.dtype).reshape(B, S, d)
    if return_stats:
        return y, aux, DispatchStats.from_run(schedule, state, res, steal_policy)
    return y, aux


def moe_ffn_nodrop_ref(x, p, cfg, group_size: int = 1024):
    """O(T·E) dense no-drop oracle: every expert applied to every token,
    combined with the routed gates: the exact answer a dropless dispatch
    must reproduce."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    _, gate_vals, idx, aux = _router(x_flat, p, cfg, group_size)
    y = expert_ffn_nodrop_ref(idx, gate_vals, x_flat, p["we_g"], p["we_u"], p["we_d"])
    if cfg.n_shared_experts:
        y = y + _shared_experts(x_flat, p).float()
    return y.to(x.dtype).reshape(B, S, d), aux
