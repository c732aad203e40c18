"""End-to-end training entry point of the port (``repro/launch/train.py``
counterpart).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-236b \
        --steps 3 --moe-dispatch ws --moe-grad-dispatch ws --device cpu

runs the smoke config on the CPU (the kernels' plain versions); on a CUDA
card drop ``--device cpu`` (the default is ``cuda``, and it raises without
one).  ``--full-config`` takes the full width, and ``--n-layers`` cuts its
depth.  Each step draws its batch from the synthetic corpus
(:func:`repro_torch.data.make_batch`) and goes through
:func:`~repro_torch.launch.steps.make_optimizer` and
:func:`~repro_torch.launch.steps.make_train_step`.

``--ws-mode`` (one of :data:`repro_torch.sched.MODES`) trains with the
paper's work-stealing rounds as the gradient-accumulation engine: each step's
``rows`` are ``--n-workers`` x ``tasks_per_worker`` microbatch tasks spread
over the workers' queues by :func:`_skewed_tails` (``--skew``), and the
step logs ``ws_coverage``.  The queue sizes are the owner's local Put, host
data: they stay on the CPU, so the schedule's few hundred integer ops run on
the host and only each round's gather indices and weights go to the card.
That placement is deliberate (``chip_smoke.py`` shows the schedule computed
on the card is the same).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 3 --ws-mode ws-wmult --skew 4 --device cpu

``--devices N`` (N > 1, a MoE config) runs the reference example's mesh
demo after training: ``moe_dispatch="mesh-ws"`` is forward-only, so
:func:`repro_torch.mesh_ws.selfcheck.run_checks` spawns N gloo ranks on this
host (on the CPU, or all on ``cuda:0``: the ranks share the card) and holds
the cross-device dispatch on 2 seeded skewed routings to the no-drop oracle,
printing each row.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-236b \
        --steps 2 --devices 4 --device cpu

Checkpoints (:mod:`repro_torch.checkpoint`, atomic and written in the
background): ``--ckpt-dir`` saves the state ``{"params", "opt"}`` every
``--ckpt-every`` steps and at the last one; ``--resume`` restores the
latest step and continues after it; ``--preempt-at N`` is the preemption
drill: after step N (and its save, if one is due) it waits for the writer
and exits with code 17, and a rerun with ``--resume`` continues.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import ARCH_MODULES, get_config
from repro_torch.data import make_batch
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import init_params
from repro_torch.models.config import ShapeConfig
from repro_torch.sched import MODES


def _skewed_tails(n_tasks: int, n_workers: int, step: int, skew: float) -> np.ndarray:
    """Deterministic per-step queue skew (the straggler/imbalance model)."""
    rng = np.random.RandomState(step * 7919 + 13)
    w = rng.dirichlet(np.full(n_workers, max(1e-3, 1.0 / max(skew, 1e-3))))
    tails = np.floor(w * n_tasks).astype(np.int64)
    while tails.sum() < n_tasks:
        tails[rng.randint(n_workers)] += 1
    return tails


def train(arch: str, *, smoke: bool = True, steps: int = 100, rows: int = 8, seq: int = 64,
          moe_dispatch: str | None = None, moe_grad_dispatch: str | None = None,
          ws_mode: str | None = None, n_workers: int = 4, tasks_per_worker: int = 2,
          skew: float = 1.0, lr: float = 3e-3, ckpt_dir: str | None = None,
          ckpt_every: int = 20, resume: bool = False, preempt_at: int | None = None,
          seed: int = 0,
          log_every: int = 10, log_path: str | None = None, n_layers: int | None = None,
          device: DeviceLike = None, params=None, on_step=None):
    """Train ``arch`` for ``steps`` steps of ``rows`` x ``seq`` tokens; returns
    ``(state, losses)``.  The knobs are the reference's; ``n_layers`` cuts the
    depth, ``device`` is ``cuda`` unless given, ``params`` replaces the
    seeded init (for example the reference's parameters carried across by
    :func:`repro_torch.convert.params_from_jax`; they are updated in place,
    unless a resume replaces them by the restored ones), and ``on_step(step,
    state, metrics, seconds)`` is called after every step.  With
    ``ckpt_dir`` the state is saved at every ``ckpt_every``-th step and at
    the last; ``resume`` restores the latest saved step there and starts at
    the next; at ``preempt_at`` the run waits for the writer and exits with
    code 17 (``os._exit``: run it in a process of its own).  With
    ``ws_mode`` a step's batch is ``n_workers * tasks_per_worker`` tasks of
    ``max(rows // n_tasks, 1)`` rows each, on queues sized by
    :func:`_skewed_tails` (kept on the CPU: see the module docstring)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if moe_dispatch is not None:
        cfg = cfg.replace(moe_dispatch=moe_dispatch)
    if moe_grad_dispatch is not None:
        cfg = cfg.replace(moe_grad_dispatch=moe_grad_dispatch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    shape = ShapeConfig("custom", "train", seq, rows)
    opt = make_optimizer(cfg, total_steps=steps, peak_lr=lr)
    if params is None:
        params = init_params(cfg, seed=seed, device=dev)
    state = {"params": params, "opt": opt.init(params)}
    start = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore(ckpt_dir, state, device=dev)
        start += 1
        print(f"[train] resumed from step {start - 1}")
    n_tasks = n_workers * tasks_per_worker
    rpt = max(rows // n_tasks, 1)
    step_fn = make_train_step(cfg, opt, ws_mode=ws_mode, n_workers=n_workers)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        if ws_mode is None:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in make_batch(cfg, shape, step, n_rows=rows, seed=seed).items()}
        else:
            nb = make_batch(cfg, shape, step, n_rows=n_tasks * rpt, seed=seed)
            batch = {k: torch.from_numpy(v).to(dev).reshape((n_tasks, rpt) + v.shape[1:])
                     for k, v in nb.items()}
            batch["tails"] = torch.from_numpy(_skewed_tails(n_tasks, n_workers, step, skew))
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t_step
        losses.append(metrics["loss"])
        if on_step is not None:
            on_step(step, state, metrics, seconds)
        if step % log_every == 0 or step == steps - 1:
            msg = {"step": step, "loss": round(metrics["loss"], 4),
                   "t": round(time.time() - t0, 1)}
            if "ws_coverage" in metrics:
                msg["ws_coverage"] = metrics["ws_coverage"]
            print(f"[train] {json.dumps(msg)}")
            if log_path:
                with open(log_path, "a") as f:
                    f.write(json.dumps(msg) + "\n")
        if ckpt and (step % ckpt_every == 0 or step == steps - 1):
            ckpt.save(step, state)
        if preempt_at is not None and step == preempt_at:
            print(f"[train] simulating preemption at step {step}", flush=True)
            if ckpt:
                ckpt.wait()
            os._exit(17)  # a hard kill, as a real preemption is
    if ckpt:
        ckpt.wait()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-v2-236b", choices=sorted(ARCH_MODULES))
    ap.add_argument("--full-config", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--n-layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--moe-dispatch", default=None, choices=["dense", "ws"])
    ap.add_argument("--moe-grad-dispatch", default=None, choices=["dense", "ws"])
    ap.add_argument("--ws-mode", default=None, choices=list(MODES),
                    help="train with the work-stealing rounds as gradient accumulation")
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--skew", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-path", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=None,
                    help="after training a MoE config, the mesh-ws demo over N ranks")
    args = ap.parse_args(argv)
    moe = get_config(args.arch, smoke=not args.full_config).is_moe
    if args.devices is not None and args.devices > 1 and not moe:
        raise ValueError(f"--devices runs the mesh-ws demo, which needs a MoE config; "
                         f"{args.arch} has no experts")
    _, losses = train(args.arch, smoke=not args.full_config, steps=args.steps,
                      rows=args.rows, seq=args.seq, moe_dispatch=args.moe_dispatch,
                      moe_grad_dispatch=args.moe_grad_dispatch, ws_mode=args.ws_mode,
                      n_workers=args.n_workers, skew=args.skew, lr=args.lr,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      resume=args.resume, preempt_at=args.preempt_at, seed=args.seed,
                      log_every=args.log_every, log_path=args.log_path,
                      n_layers=args.n_layers, device=args.device)
    k = max(len(losses) // 10, 1)
    print(f"[train] done: first-{k} mean loss {np.mean(losses[:k]):.4f} -> "
          f"last-{k} mean loss {np.mean(losses[-k:]):.4f}")
    if args.devices is not None and args.devices > 1:
        from repro_torch.mesh_ws.selfcheck import run_checks

        dev = resolve_device(args.device)
        print(f"[train] mesh-ws demo: {args.devices} ranks on {dev.type}, n_experts=16")
        rows = run_checks(args.devices, seeds=2, device=dev.type)
        for r in rows:
            print(f"  seed={r['seed']} max_abs_err={r['max_abs_err']:.3g} "
                  f"within_tol={r['within_tol']} ranks_equal={r['ranks_equal']} "
                  f"devices_stole={r['devices_stole']} tiles_stolen={r['tiles_stolen']}")
        if not all(r["within_tol"] and r["ranks_equal"] for r in rows):
            raise RuntimeError(f"mesh-ws demo diverged from the no-drop oracle: {rows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
