"""Fence-free work-stealing expert megakernels, forward and backward:
wrappers and plain versions (port of ``repro/moe_ws/expert_kernel.py``).

One task is ``row_len`` routed rows of one expert's gated FFN:

    gather   xt = x[tok_idx[rs : rs + bt]]                 # [bt, d] fp32
    FFN      y  = silu(xt @ wg[e]) * (xt @ wu[e]) @ wd[e]   # [bt, f] -> [bt, d]
    mask     rows at or past row_len are zero
    write    out[rs : rs + bt]                              # lockstep +=, free =

The TPU kernel is the tile body ``_expert_execute`` inside the scheduler
shell of ``launch_ws_grid``.  Here it is the hand-written CUDA kernel
``csrc/ws_expert.cu`` (the shared scheduler of ``csrc/ws_sched.cuh`` around
the tensor-core tile of ``csrc/ws_expert_mma.cuh``: one CTA a program, each
warp streaming weight strips through its own cp.async ring onto
``mma.sync``), launched by :func:`launch_moe_grid` for CUDA tensors, and
:func:`plain_moe_grid` for CPU tensors: the scheduler walk shared with the
attention family (``pallas_ws.kernel._PlainWalk``) with the expert tile in
torch fp32.  The modes are the attention family's: lockstep is the
reference's order and accumulates ``tile × mult``; free mode runs P
concurrent CTAs that store whole tiles, so its ``out`` is already
normalised, and breaks the cost policy's victim ties in each program's
rotation (``rotate_ties``; the kernels' ``ROT`` walks), so thieves that
read equal advisories spread over the queues.

Backward: one task is the transpose of the same tile.  It gathers its rows'
activations and output cotangents, replays the FFN and emits per row

    [dx (d) | du (f) | dv (f) | h (f) | dgate (1)]     # fp32 [bt, d + 3f + 1]

the pieces of the no-drop reference VJP (:func:`grad_out_width`).  Every
output is per routed row, hence disjoint across tiles, so duplicates are
normalised exactly as in the forward.  The TPU kernel is the tile body
``_expert_grad_execute``; here it is ``csrc/ws_expert_grad.cu``, launched
by :func:`launch_moe_grad_grid` for CUDA tensors, with
:func:`plain_moe_grad_grid` (the shared walk with the tile in torch fp32)
for CPU tensors.  Both kernels take dense or shared-pool queues.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.pallas_ws.kernel import (
    MODES,
    NO_RING,
    RING_ARGTYPES,
    STEAL_POLICIES,
    WSRunResult,
    _PlainWalk,
    launch_grid,
    launches,
    queue_dims,
    scheduler_knobs,
)
from repro_torch.pallas_ws.queues import QueueState
from repro_torch.pallas_ws.tasks import BOTTOM, F_COST, F_E, F_OP, F_RL, F_RS, F_TID

# The tiles of csrc/ws_expert_mma.cuh run 16-column mma.sync tiles: d and f
# must be multiples of 16 and the weights 16-byte aligned.
EXPERT_COLS = 16

# The tiles' shared memory (xmma::tile_smem of csrc/ws_expert_mma.cuh,
# mirrored here so that the host refuses a tile that does not fit before
# any launch; the C launch refuses it too): a 1 KB header, one (forward: h)
# or two (backward: t then du, and dv) [8, f + 8] fp32 tiles, and a
# cp.async ring a warp (8 warps) of what is left up to 20 KB, beside 256
# bytes kept for the kernels' static shared memory.  A program is one CTA.
SMEM_LIMIT = 232448          # a CTA's shared memory on the H100
_STATIC, _HDR, _RB, _NW, _RING_W_MAX = 256, 1024, 8, 8, 20480
# The smallest ring a warp needs: forward 4 stages of 16 k of wg's and wu's
# 64 columns and of the 8 rows' x; backward 4 stages of 16 k of 64 rows of
# wd and of the rows' cotangents.
_MIN_RING_W = {False: 4 * (2 * 16 * 128 + 8 * 16 * 4), True: 4 * (64 * 32 + 8 * 16 * 4)}


def tile_smem(f: int, *, grad: bool = False):
    """``(smem, ring_w)``: the dynamic shared memory of an expert launch at
    hidden width ``f`` and each warp's ring bytes, as the C entry points
    compute them.  Raises ``ValueError`` where a warp's ring cannot hold
    its smallest stages within ``SMEM_LIMIT`` (the launch would be
    refused)."""
    fixed = _HDR + (2 if grad else 1) * _RB * (f + 8) * 4
    ring_w = min((SMEM_LIMIT - _STATIC - fixed) // _NW, _RING_W_MAX) & ~15
    if ring_w < _MIN_RING_W[grad]:
        raise ValueError(f"the {'grad ' if grad else ''}expert tile at f={f} needs "
                         f"{fixed + _NW * _MIN_RING_W[grad] + _STATIC} B of shared memory, past the "
                         f"{SMEM_LIMIT} B a CTA can have")
    return fixed + _NW * ring_w, ring_w


def resident_programs(dtype, f: int, *, grad: bool = False) -> int:
    """CTAs of the free kernel the card holds at once at hidden width ``f``
    (occupancy x SMs): every program of a launch runs at once when P is at
    most this (on the card; builds the kernel)."""
    from .. import _build

    name = "ws_expert_grad" if grad else "ws_expert"
    fn = getattr(_build.load(name), f"{name}_resident")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    n = fn(1 if dtype == torch.bfloat16 else 0, f)
    if n < 0:
        raise RuntimeError(f"{name}: occupancy query failed with CUDA error {-n}")
    return n


class _ExpertWalk(_PlainWalk):
    """The plain version of ``csrc/ws_expert.cu``: the shared walk with the
    expert tile in torch fp32 on the tensors' device."""

    def __init__(self, arrs, x, tok_idx, wg, wu, wd, out, *, bt, steal, policy):
        super().__init__(arrs, steal=steal, policy=policy)
        self.x, self.tok_idx, self.out = x, tok_idx.long(), out
        self.wg, self.wu, self.wd = wg, wu, wd
        self.bt = bt

    def execute(self, fq, fs, *, store):
        rec = self.rec(fq, fs)
        e, rs, rl = rec[F_E], rec[F_RS], rec[F_RL]
        xt = self.x[self.tok_idx[rs:rs + self.bt]]                      # gather [bt, d]
        h = F.silu(xt @ self.wg[e].float()) * (xt @ self.wu[e].float())
        y = h @ self.wd[e].float()
        y[rl:] = 0.0
        if store:
            self.out[rs:rs + self.bt] = y
        else:
            self.out[rs:rs + self.bt] += y


def _check_expert_records(state: QueueState, *, n_experts, n_rows, bt, n_tasks) -> None:
    """The kernel indexes the weights, tok_idx/out and mult with the live
    records' fields, and the pool's records with ``pool_off`` and ``tail``:
    reject a host-built state that would read or write out of bounds."""
    tasks = state.tasks
    if state.pool:
        off, tail = np.asarray(state.pool_off), np.asarray(state.tail)
        if (off.shape != (state.n_queues + 1,) or (off[:-1] < 0).any()
                or (off[:-1] + tail > tasks.shape[0]).any()):
            raise ValueError(f"pool segments out of range for {tasks.shape[0]} slots: "
                             f"pool_off {off.tolist()}, tail {tail.tolist()}")
    live = tasks[tasks[..., F_OP] != BOTTOM]
    if not live.size:
        return
    bad = ((live[:, F_E] < 0) | (live[:, F_E] >= n_experts) | (live[:, F_RS] < 0)
           | (live[:, F_RS] + bt > n_rows) | (live[:, F_TID] < 0)
           | (live[:, F_TID] >= n_tasks) | (live[:, F_COST] < 0))
    if bad.any():
        raise ValueError(f"expert task record out of range for E={n_experts}, "
                         f"n_rows={n_rows}, bt={bt}: {live[bad][0].tolist()}")


def _check_inputs(state: QueueState, x, tok_idx, wg, wu, wd, *, bt, plain: bool):
    """Checks shared by both expert kernels; returns ``(d, f, n_rows)``."""
    dev = x.device
    if not all(t.device == dev for t in (tok_idx, wg, wu, wd)):
        raise ValueError("x, tok_idx, wg, wu and wd must lie on one device")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 [T, d]: {x.dtype} {tuple(x.shape)}")
    T, d = x.shape
    if not (wg.dtype == wu.dtype == wd.dtype) or wg.dtype not in (torch.float32,
                                                                  torch.bfloat16):
        raise ValueError(f"wg, wu, wd must share dtype float32 or bfloat16: "
                         f"{wg.dtype}, {wu.dtype}, {wd.dtype}")
    E, _, f = wg.shape
    if (wg.shape != (E, d, f) or wu.shape != (E, d, f) or wd.shape != (E, f, d)
            or not (wg.is_contiguous() and wu.is_contiguous() and wd.is_contiguous())):
        raise ValueError(f"weights must be contiguous wg/wu [E, d, f], wd [E, f, d] for "
                         f"d={d}: {tuple(wg.shape)}, {tuple(wu.shape)}, {tuple(wd.shape)}")
    if tok_idx.dtype != torch.int32 or tok_idx.dim() != 1 or not tok_idx.is_contiguous():
        raise ValueError(f"tok_idx must be contiguous int32 [n_rows]: {tok_idx.dtype}")
    n_rows = tok_idx.shape[0]
    if isinstance(state.tasks, np.ndarray):
        _check_expert_records(state, n_experts=E, n_rows=n_rows, bt=bt,
                              n_tasks=max(1, state.n_tasks))
    if not plain and (d % EXPERT_COLS or f % EXPERT_COLS or any(
            w.data_ptr() % 16 for w in (x, wg, wu, wd))):
        raise ValueError(f"the expert kernels need d and f multiples of {EXPERT_COLS} "
                         f"and 16-byte aligned x and weights: d={d}, f={f}")
    return d, f, n_rows


def _check_out(out, shape, dev):
    if (out.device != dev or out.dtype != torch.float32 or not out.is_contiguous()
            or tuple(out.shape) != shape):
        raise ValueError(f"out must be contiguous float32 {shape} on {dev}: "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")


def _run(state: QueueState, x, tok_idx, wg, wu, wd, out, *, bt, plain: bool,
         steal=True, steal_policy="cost", steal_run_cap=1, rounds=None, mult=None,
         compress_runs=None, mode=None, trace=False, trace_capacity=None,
         fault_plan=None) -> WSRunResult:
    mode, compress = scheduler_knobs(
        steal=steal, steal_policy=steal_policy, steal_run_cap=steal_run_cap, mode=mode,
        compress_runs=compress_runs)
    d, _, n_rows = _check_inputs(state, x, tok_idx, wg, wu, wd, bt=bt, plain=plain)
    _check_out(out, (n_rows, d), x.device)

    def walk(arrs, **kw):
        return _ExpertWalk(arrs, x, tok_idx, wg, wu, wd, out, bt=bt, **kw)

    def launch(arrs, **kw):
        _launch_cuda(arrs, x, tok_idx, wg, wu, wd, out, bt=bt, **kw)

    return launch_grid(state, out, walk=walk, launch=launch, plain=plain, mode=mode,
                       compress=compress, steal=steal, steal_policy=steal_policy,
                       rounds=rounds, mult=mult, trace=trace, trace_capacity=trace_capacity,
                       fault_plan=fault_plan, steal_run_cap=steal_run_cap, rotate_ties=True)


def _kernel_fn():
    """The C entry point of ``csrc/ws_expert.cu`` (built at first use)."""
    from .. import _build

    fn = _build.load("ws_expert").ws_expert_launch
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # mode, dtype; 12 int32 arrays (pool_off null on the dense layout);
        # x, tok_idx, wg, wu, wd, out; 9 sizes and flags (run_cap last);
        # d, f, bt; the ring; stream
        fn.argtypes = [i, i] + [ptr] * 12 + [ptr] * 6 + [i] * 9 + [i] * 3 + RING_ARGTYPES + [ptr]
        fn.restype = i
    return fn


_QUEUE_ARRAYS = ("tasks", "pool_off", "tail", "head", "local_head", "taken", "remaining",
                 "clock", "work", "steals", "scanned", "mult")


def _queue_args(arrs):
    """The 12 queue pointers of both expert entry points (pool_off is null on
    the dense layout)."""
    return [arrs[n].data_ptr() if n in arrs else None for n in _QUEUE_ARRAYS]


def _launch_cuda(arrs, x, tok_idx, wg, wu, wd, out, *, mode, rounds, steal, policy,
                 compress, bt, n_tasks, ring=NO_RING, run_cap=1) -> None:
    tile_smem(wg.shape[2])  # refuses a tile past SMEM_LIMIT
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        MODES.index(mode), 1 if wg.dtype == torch.bfloat16 else 0,
        *_queue_args(arrs),
        x.data_ptr(), tok_idx.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        out.data_ptr(),
        *queue_dims(arrs), n_tasks, rounds, int(steal), STEAL_POLICIES.index(policy),
        int(compress), run_cap, x.shape[1], wg.shape[2], bt, *ring, stream,
    )
    launches["ws_expert"] += 1
    if err != 0:
        raise RuntimeError(f"ws_expert launch failed with CUDA error {err}")


def launch_moe_grid(state: QueueState, x, tok_idx, wg, wu, wd, out, *, bt: int,
                    **kw) -> WSRunResult:
    """Run the work-stealing grid with the expert tile body.  ``out``
    ([n_rows, d] fp32, contiguous) is written in place: lockstep accumulates
    into it, free mode stores.  Keywords: the scheduler's (``steal``,
    ``steal_policy``, ``rounds``, ``mult``, ``compress_runs``, ``mode``, ...).

    CUDA tensors launch ``csrc/ws_expert.cu``; CPU tensors run the plain
    version.  There is no fallback between the two.
    """
    return _run(state, x, tok_idx, wg, wu, wd, out, bt=bt,
                plain=x.device.type == "cpu", **kw)


def plain_moe_grid(state: QueueState, x, tok_idx, wg, wu, wd, out, *, bt: int,
                   **kw) -> WSRunResult:
    """The plain PyTorch version of :func:`launch_moe_grid` on any device: the
    scheduler walk on the host, the tile math in torch on the tensors' device."""
    return _run(state, x, tok_idx, wg, wu, wd, out, bt=bt, plain=True, **kw)


def run_moe_schedule(state: QueueState, x, tok_idx, wg, wu, wd, *, bt: int,
                     steal: bool = True, steal_policy: str = "cost",
                     steal_run_cap: int = 1, rounds: Optional[int] = None, out=None,
                     mult=None, compress_runs: Optional[bool] = None,
                     mode: Optional[str] = None, trace: bool = False,
                     trace_capacity: Optional[int] = None,
                     fault_plan=None) -> WSRunResult:
    """Launch the expert megakernel over a prepared :class:`QueueState`.

    ``x``: [T, d] token activations (taken as fp32); ``tok_idx``: [n_rows]
    routed row → token map (``RoutedSet.tok_idx``, numpy or a tensor);
    ``wg``/``wu``: [E, d, f]; ``wd``: [E, f, d], fp32 or bf16.  ``out`` is
    the routed-row output [n_rows, d] fp32, carried over on relaunch for the
    multiplicity drills, as is ``mult``.  ``trace`` records the event rings
    and ``fault_plan`` injects a plan's launch faults
    (``pallas_ws.kernel.launch_grid``).
    """
    x, tok_idx, out = _prepare(x, tok_idx, out, x.shape[1])
    return launch_moe_grid(state, x, tok_idx, wg, wu, wd, out, bt=bt, steal=steal,
                           steal_policy=steal_policy, steal_run_cap=steal_run_cap,
                           rounds=rounds, mult=mult, compress_runs=compress_runs,
                           mode=mode, trace=trace, trace_capacity=trace_capacity,
                           fault_plan=fault_plan)


def _prepare(x, tok_idx, out, width: int):
    """fp32 contiguous ``x``, int32 ``tok_idx`` on x's device (range-checked
    on the host), and a fresh or carried-over (copied) ``out`` [n_rows, width]."""
    dev = x.device
    x = x.float().contiguous()
    if isinstance(tok_idx, torch.Tensor):
        tok_idx = tok_idx.to(device=dev, dtype=torch.int32).contiguous()
    else:
        tok_host = np.asarray(tok_idx)
        if tok_host.size and (tok_host.min() < 0 or tok_host.max() >= x.shape[0]):
            raise ValueError(f"tok_idx out of range for T={x.shape[0]}")
        tok_idx = torch.from_numpy(tok_host.astype(np.int32)).to(dev)
    shape = (tok_idx.shape[0], width)
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        out = torch.as_tensor(out, dtype=torch.float32).to(dev).clone().contiguous()
        if tuple(out.shape) != shape:
            raise ValueError(f"carried out has shape {tuple(out.shape)}, expected {shape}")
    return x, tok_idx, out


# ---------------------------------------------------------------------------
# backward: the transpose tile


def grad_out_width(d: int, f: int) -> int:
    """Columns of the grad launch's per-row output block:
    ``[dx (d) | du (f) | dv (f) | h (f) | dgate (1)]``."""
    return d + 3 * f + 1


def dsilu(u, sig):
    """d/du silu(u) given ``sig = sigmoid(u)``: the one form both backward
    evaluations (the dense transpose and the grad tile) use."""
    return sig * (1.0 + u * (1.0 - sig))


class _ExpertGradWalk(_PlainWalk):
    """The plain version of ``csrc/ws_expert_grad.cu``: the shared walk with
    the transpose tile (``_expert_grad_execute``) in torch fp32."""

    def __init__(self, arrs, x, gy, tok_idx, gate_rows, wg, wu, wd, out, *, bt, steal,
                 policy):
        super().__init__(arrs, steal=steal, policy=policy)
        self.x, self.gy, self.tok_idx, self.gate_rows = x, gy, tok_idx.long(), gate_rows
        self.wg, self.wu, self.wd, self.out = wg, wu, wd, out
        self.bt = bt

    def execute(self, fq, fs, *, store):
        rec = self.rec(fq, fs)
        e, rs, rl = rec[F_E], rec[F_RS], rec[F_RL]
        tok = self.tok_idx[rs:rs + self.bt]
        xt, ct = self.x[tok], self.gy[tok]                              # [bt, d]
        gr = self.gate_rows[rs:rs + self.bt]
        wg, wu, wd = self.wg[e].float(), self.wu[e].float(), self.wd[e].float()
        # replay the forward tile
        u, v = xt @ wg, xt @ wu
        sig = torch.sigmoid(u)
        s = u * sig
        h = s * v
        yhat = h @ wd
        # closed-form transpose of gate · (silu(x wg) ⊙ (x wu)) wd
        dgate = (ct * yhat).sum(-1, keepdim=True)
        dh = (gr[:, None] * ct) @ wd.T
        dv = dh * s
        du = dh * v * dsilu(u, sig)
        dxr = du @ wg.T + dv @ wu.T
        block = torch.cat([dxr, du, dv, h, dgate], dim=1)
        block[rl:] = 0.0
        if store:
            self.out[rs:rs + self.bt] = block
        else:
            self.out[rs:rs + self.bt] += block


def _run_grad(state: QueueState, x, gy, tok_idx, gate_rows, wg, wu, wd, out, *, bt,
              plain: bool, steal=True, steal_policy="cost", steal_run_cap=1,
              rounds=None, mult=None, compress_runs=None, mode=None, trace=False,
              trace_capacity=None) -> WSRunResult:
    mode, compress = scheduler_knobs(
        steal=steal, steal_policy=steal_policy, steal_run_cap=steal_run_cap, mode=mode,
        compress_runs=compress_runs)
    d, f, n_rows = _check_inputs(state, x, tok_idx, wg, wu, wd, bt=bt, plain=plain)
    dev = x.device
    if (gy.device != dev or gy.dtype != torch.float32 or not gy.is_contiguous()
            or gy.shape != x.shape or (not plain and gy.data_ptr() % 16)):
        raise ValueError(f"gy must be contiguous (16-byte aligned) float32 {tuple(x.shape)} "
                         f"on {dev}: {gy.dtype} {tuple(gy.shape)}")
    if (gate_rows.device != dev or gate_rows.dtype != torch.float32
            or tuple(gate_rows.shape) != (n_rows,) or not gate_rows.is_contiguous()):
        raise ValueError(f"gate_rows must be contiguous float32 [{n_rows}] on {dev}")
    _check_out(out, (n_rows, grad_out_width(d, f)), dev)

    def walk(arrs, **kw):
        return _ExpertGradWalk(arrs, x, gy, tok_idx, gate_rows, wg, wu, wd, out, bt=bt, **kw)

    def launch(arrs, **kw):
        _launch_grad_cuda(arrs, x, gy, tok_idx, gate_rows, wg, wu, wd, out, bt=bt, **kw)

    return launch_grid(state, out, walk=walk, launch=launch, plain=plain, mode=mode,
                       compress=compress, steal=steal, steal_policy=steal_policy,
                       rounds=rounds, mult=mult, trace=trace, trace_capacity=trace_capacity,
                       steal_run_cap=steal_run_cap, rotate_ties=True)


def _grad_kernel_fn():
    """The C entry point of ``csrc/ws_expert_grad.cu`` (built at first use)."""
    from .. import _build

    fn = _build.load("ws_expert_grad").ws_expert_grad_launch
    if fn.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        # mode, dtype; 12 int32 arrays; x, gy, tok_idx, gate_rows, wg, wu, wd,
        # out; 9 sizes and flags (run_cap last); d, f, bt; the ring; stream
        fn.argtypes = [i, i] + [ptr] * 12 + [ptr] * 8 + [i] * 9 + [i] * 3 + RING_ARGTYPES + [ptr]
        fn.restype = i
    return fn


def _launch_grad_cuda(arrs, x, gy, tok_idx, gate_rows, wg, wu, wd, out, *, mode, rounds,
                      steal, policy, compress, bt, n_tasks, ring=NO_RING, run_cap=1) -> None:
    tile_smem(wg.shape[2], grad=True)  # refuses a tile past SMEM_LIMIT
    fn = _grad_kernel_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(
        MODES.index(mode), 1 if wg.dtype == torch.bfloat16 else 0,
        *_queue_args(arrs),
        x.data_ptr(), gy.data_ptr(), tok_idx.data_ptr(), gate_rows.data_ptr(),
        wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
        *queue_dims(arrs), n_tasks, rounds, int(steal), STEAL_POLICIES.index(policy),
        int(compress), run_cap, x.shape[1], wg.shape[2], bt, *ring, stream,
    )
    launches["ws_expert_grad"] += 1
    if err != 0:
        raise RuntimeError(f"ws_expert_grad launch failed with CUDA error {err}")


def launch_moe_grad_grid(state: QueueState, x, gy, tok_idx, gate_rows, wg, wu, wd, out, *,
                         bt: int, **kw) -> WSRunResult:
    """Run the work-stealing grid with the transpose tile body.  ``out``
    ([n_rows, grad_out_width(d, f)] fp32, contiguous) is written in place:
    lockstep accumulates into it, free mode stores.

    CUDA tensors launch ``csrc/ws_expert_grad.cu``; CPU tensors run the
    plain version.  There is no fallback between the two.
    """
    return _run_grad(state, x, gy, tok_idx, gate_rows, wg, wu, wd, out, bt=bt,
                     plain=x.device.type == "cpu", **kw)


def plain_moe_grad_grid(state: QueueState, x, gy, tok_idx, gate_rows, wg, wu, wd, out, *,
                        bt: int, **kw) -> WSRunResult:
    """The plain PyTorch version of :func:`launch_moe_grad_grid` on any device."""
    return _run_grad(state, x, gy, tok_idx, gate_rows, wg, wu, wd, out, bt=bt, plain=True,
                     **kw)


def run_moe_grad_schedule(state: QueueState, x, gy, tok_idx, gate_rows, wg, wu, wd, *,
                          bt: int, steal: bool = True, steal_policy: str = "cost",
                          steal_run_cap: int = 1, rounds: Optional[int] = None, out=None,
                          mult=None, compress_runs: Optional[bool] = None,
                          mode: Optional[str] = None, trace: bool = False,
                          trace_capacity: Optional[int] = None) -> WSRunResult:
    """Launch the transpose (backward) megakernel over a prepared
    :class:`QueueState`: the second launch of the custom VJP's
    ``grad_dispatch="ws"`` backward.

    ``gy``: [T, d] cotangent of the combined routed output; ``gate_rows``:
    [n_rows] per-row combine gates (``RoutedSet.gates``); the rest as
    :func:`run_moe_schedule`.  ``res.out`` is the per-row VJP block
    ``[n_rows, grad_out_width(d, f)]`` (lockstep: tile x mult, divide by the
    tile divisor before use; free: already normalised), carried over on
    relaunch for the multiplicity drills, as is ``mult``.  ``trace`` records
    the event rings; as in the reference there is no ``fault_plan`` here
    (chaos drives this kernel with plans without launch faults).
    """
    x, tok_idx, out = _prepare(x, tok_idx, out, grad_out_width(x.shape[1], wg.shape[2]))
    gy = gy.to(device=x.device, dtype=torch.float32).contiguous()
    gate_rows = torch.as_tensor(gate_rows, dtype=torch.float32).to(x.device).contiguous()
    return launch_moe_grad_grid(state, x, gy, tok_idx, gate_rows, wg, wu, wd, out, bt=bt,
                                steal=steal, steal_policy=steal_policy,
                                steal_run_cap=steal_run_cap, rounds=rounds, mult=mult,
                                compress_runs=compress_runs, mode=mode, trace=trace,
                                trace_capacity=trace_capacity)
