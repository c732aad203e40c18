"""``moe_ffn_ws``: dropless MoE FFN on the fence-free work-stealing tile
scheduler, forward only (port of ``repro/moe_ws/layer.py``).

Drop-in for :func:`repro_torch.models.moe.moe_ffn` (same ``(y, aux_loss)``
return, same router math) with the capacity-dropping dispatch replaced by
expert-tile tasks through the expert megakernel:

* router top-k → per-expert owner queues (the host Put,
  ``dispatch.route_to_tasks``): every routed (token, expert) pair gets a
  task row; nothing is dropped;
* programs Take their own expert's tiles and Steal from overloaded experts'
  stale head views (plain loads and stores only);
* the combine divides each routed row by its tile's execution count in
  lockstep mode (a free-mode ``out`` is already normalised), then
  scatter-adds ``gate × row`` back to the tokens with ``index_add_``, plain
  torch, as the reference computes it outside Pallas.

Not ported yet, and raising ``NotImplementedError``: the backward (the
reference's custom VJP, ``grad_dispatch="ws"``, or any input that requires
grad), the traced Puts (``queue_layout="pool"``), ``steal_run_cap > 1`` and
trace rings.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.pallas_ws.queues import make_queue_state
from repro_torch.pallas_ws.ragged import RaggedStats as DispatchStats  # family-neutral

from .dispatch import route_to_tasks, row_divisor
from .expert_kernel import run_moe_schedule

SCHEDULES = ("ws", "static")
QUEUE_LAYOUTS = ("pool", "padded")
GRAD_DISPATCHES = ("dense", "ws")


def _router(x_flat, p, cfg, group_size: int):
    """The dense path's router (``models.moe.router_topk``), reshaped to flat
    [T, ...] views."""
    from repro_torch.models.moe import router_topk

    T, d = x_flat.shape
    g = min(group_size, T)
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
    n_live = state.n_tasks
    if n_live and not bool((res.mult[:n_live] >= 1).all()):
        missing = int((res.mult[:n_live] == 0).sum())
        raise RuntimeError(f"expert scheduler under-provisioned: {missing}/{n_live} "
                           "tiles never executed (rounds bound too small?)")


def _check_forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("the ws dispatch's backward (custom VJP) is not "
                                  "ported yet: run it under torch.no_grad()")


def combine_routed(routed, tasks, res):
    """Multiplicity-normalised, gate-weighted combine of an expert-kernel run:
    a lockstep ``out`` is divided row by row by its tile's execution count
    (a free-mode ``out`` holds plain stores and is used as it is), then
    ``gate × row`` is scatter-added back to the tokens.  Pad rows carry gate
    0, so they vanish.  Returns [n_tokens, d] float32 on ``res.out``'s device.

    ``tasks`` is the host task list; the traced layout (``tasks=None``) is
    not ported yet.
    """
    if tasks is None:
        raise NotImplementedError("the traced combine (tasks=None) is not ported yet")
    out = res.out
    if res.mode == "lockstep":
        div = row_divisor(tasks, res.mult.cpu().numpy(), routed.n_rows)
        out = out / torch.from_numpy(div).to(out.device)[:, None]
    dev = out.device
    tok = torch.as_tensor(np.asarray(routed.tok_idx), dtype=torch.int64).to(dev)
    gates = torch.as_tensor(np.asarray(routed.gates), dtype=torch.float32).to(dev)
    y = torch.zeros((routed.n_tokens, out.shape[-1]), dtype=torch.float32, device=dev)
    return y.index_add_(0, tok, gates[:, None] * out)


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


def _dispatch_and_run(x_flat, idx, gate_vals, wg, wu, wd, *, schedule, steal_policy,
                      n_programs, bt, mode):
    """Host Put + megakernel launch + combine.  Returns ``(y [T, d] f32,
    state, res)``."""
    E = wg.shape[0]
    # With stealing every expert gets its own queue; the static baseline
    # needs every queue owned by a program, so experts are placed
    # round-robin over programs (classic expert parallelism).
    steal = schedule == "ws"
    n_queues = E if steal else n_programs
    tasks, routed = route_to_tasks(idx.cpu().numpy(), gate_vals.float().cpu().numpy(),
                                   E, bt=bt)
    state = make_queue_state(tasks, n_programs, n_queues=n_queues, partition="owner")
    res = run_moe_schedule(state, x_flat, routed.tok_idx, wg, wu, wd, bt=bt,
                           steal=steal, steal_policy=steal_policy, mode=mode)
    _check_drained(state, res)
    return combine_routed(routed, tasks, res), state, res


def _check_knobs(schedule, steal_run_cap, queue_layout, grad_dispatch, trace):
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}: {schedule!r}")
    if queue_layout not in (None,) + QUEUE_LAYOUTS:
        raise ValueError(f"queue_layout must be None or one of {QUEUE_LAYOUTS}")
    if queue_layout == "pool":
        raise NotImplementedError("the shared-pool (traced) Put is not ported yet")
    if grad_dispatch not in GRAD_DISPATCHES:
        raise ValueError(f"grad_dispatch must be one of {GRAD_DISPATCHES}")
    if grad_dispatch == "ws":
        raise NotImplementedError("grad_dispatch='ws' (the backward megakernel) is "
                                  "not ported yet")
    if steal_run_cap != 1:
        raise NotImplementedError("steal_run_cap > 1 is not ported yet")
    if trace:
        raise NotImplementedError("trace rings are not ported yet")


def moe_ffn_ws(x, p, cfg, group_size: int = 1024, *, schedule: str = "ws",
               steal_policy: str = "cost", steal_run_cap: int = 1,
               queue_layout: Optional[str] = None, grad_dispatch: str = "dense",
               n_programs: int = 8, bt: int = 8, mode: Optional[str] = None,
               return_stats: bool = False, trace: bool = False):
    """x: [B, S, d] -> (y: [B, S, d], aux_loss scalar): the dropless ws
    dispatch.

    ``schedule="ws"`` steals over per-expert queues; ``"static"`` drains
    owner queues only (experts round-robin over programs, same kernel).
    ``steal_policy`` is ``"cost"`` (own queue, then the argmax of the
    advisory) or ``"scan"``.  ``bt`` is the tile height, ``n_programs`` the
    program count, ``mode`` the kernel's (``"free"`` by default, or
    ``"lockstep"``).  ``grad_dispatch`` names the backward's evaluation; the
    port is forward only, so ``"ws"`` and inputs that require grad raise.
    ``return_stats`` appends the launch's :class:`DispatchStats`.
    """
    _check_knobs(schedule, steal_run_cap, queue_layout, grad_dispatch, trace)
    _check_forward_only(x, p["we_g"], p["we_u"], p["we_d"], p["router"])
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    _, gate_vals, idx, aux = _router(x_flat, p, cfg, group_size)
    y, state, res = _dispatch_and_run(
        x_flat, idx, gate_vals, p["we_g"], p["we_u"], p["we_d"], schedule=schedule,
        steal_policy=steal_policy, n_programs=n_programs, bt=bt, mode=mode)
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
