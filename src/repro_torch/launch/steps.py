"""Train-step builders (port of ``repro/launch/steps.py``).

``train_policy(cfg)`` makes the reference's scale-dependent choices from
the analytic parameter count: under 8 B parameters AdamW with fp32 states
and no fsdp, to 500 B AdamW with fsdp, above that the bf16-momentum
factored optimizer.  The port runs on one card and has no fsdp, so it
raises where the policy asks for it.  The step is eager:
``torch.autograd.grad`` of :func:`repro_torch.models.loss_fn`, then the
optimizer's in-place update.  With ``cfg.moe_dispatch == "ws"`` the loss's
experts run forward on the expert megakernel and backward through the
layer's custom VJP (``cfg.moe_grad_dispatch``), so no dense dispatch ever
substitutes on the training path.  ``ws_mode`` (one of
:data:`repro_torch.sched.MODES`) runs the step's batch as microbatch tasks
through the paper's work-stealing rounds
(:func:`repro_torch.sched.ws_accumulate_grads`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import loss_fn
from repro_torch.optim import (
    cosine_schedule,
    make_adafactor_momentum,
    make_adamw,
    tree_leaves,
    tree_map,
    wsd_schedule,
)
from repro_torch.sched import MODES, ws_accumulate_grads


def train_policy(cfg) -> Dict[str, Any]:
    n = cfg.param_count()
    if n > 500e9:
        return {"fsdp": "pods", "optimizer": "adafactor_momentum"}
    if n > 8e9:
        return {"fsdp": True, "optimizer": "adamw"}
    return {"fsdp": False, "optimizer": "adamw"}


def make_optimizer(cfg, total_steps: int = 10_000, peak_lr: float = 3e-4):
    """The policy's optimizer with the reference's schedule (WSD for
    depth-scaled residual configs, cosine otherwise)."""
    pol = train_policy(cfg)
    if cfg.depth_scaled_residual:
        lr = wsd_schedule(peak_lr, warmup=total_steps // 100 + 1,
                          stable=int(total_steps * 0.8), decay=total_steps // 5 + 1)
    else:
        lr = cosine_schedule(peak_lr, warmup=total_steps // 100 + 1, total=total_steps)
    if pol["optimizer"] == "adafactor_momentum":
        return make_adafactor_momentum(lr)
    return make_adamw(lr)


def _check_dispatch(cfg) -> None:
    for knob in ("moe_dispatch", "moe_grad_dispatch"):
        val = getattr(cfg, knob)
        if val not in ("dense", "ws"):
            # "mesh-ws" is forward/serving-only in the reference; anything
            # else would select no training-capable dispatch
            raise ValueError(f"cfg.{knob}={val!r}: expected 'dense' or 'ws' "
                             "(training-capable dispatches)")


def loss_and_grads(params, cfg, batch, *, remat: bool = True, chunk: int = 1024):
    """``(loss, metrics, grads)`` of one batch: grads is a tree shaped like
    ``params`` in the parameters' dtypes (no fp32 copy)."""
    _check_dispatch(cfg)
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, cfg, batch, remat=remat, chunk=chunk)
    flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    # no closure cycle may hold ``flat``: it would keep a step's 10 GB of
    # grads alive past the step until the cyclic garbage collector runs
    grads = tree_map(lambda _: next(flat), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, opt, *, ws_mode: Optional[str] = None, n_workers: int = 0,
                    sync_every: int = 1, max_rounds: Optional[int] = None, remat: bool = True,
                    chunk: int = 1024) -> Callable:
    """``state = {"params", "opt"}``; ``step(state, batch)`` returns the new
    state (the parameters and optimizer state updated in place) and its
    metrics as floats.

    ``ws_mode=None``: one full-batch loss; metrics ``loss``, ``ce``, ``aux``.
    ``ws_mode`` in :data:`repro_torch.sched.MODES`: ``batch["tails"]`` gives
    each of the ``n_workers`` queues' task count, and every other leaf is
    ``[n_tasks, rows, ...]``, a FIFO of microbatch tasks that the rounds
    schedule; each round's loss is ``loss_fn`` over the round's
    ``n_workers * rows`` rows with the multiplicity row weights.  Metrics
    ``loss``, ``ce`` (= the loss), ``ws_coverage`` and ``ws_extractions``.
    """
    if ws_mode is not None:
        if ws_mode not in MODES:
            raise ValueError(f"ws_mode {ws_mode!r} not in {MODES}")
        if n_workers < 1:
            raise ValueError(f"ws_mode {ws_mode!r} needs n_workers >= 1, got {n_workers}")
    if train_policy(cfg)["fsdp"]:
        raise NotImplementedError(f"{cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters "
                                  "need fsdp, which the one-card port does not have")
    _check_dispatch(cfg)

    def flat_loss(p, flat, row_w):
        return loss_fn(p, cfg, flat, remat=remat, chunk=chunk, row_weights=row_w)[0]

    def step(state, batch):
        params = state["params"]
        if ws_mode is None:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, remat=remat, chunk=chunk)
            out = {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}
        else:
            micro = {k: v for k, v in batch.items() if k != "tails"}
            loss, grads, aux = ws_accumulate_grads(
                flat_loss, params, micro, batch["tails"], n_workers=n_workers, mode=ws_mode,
                sync_every=sync_every, max_rounds=max_rounds, flat_loss=True)
            out = {"loss": float(loss), "ce": float(loss),
                   "ws_coverage": float(aux["coverage"]),
                   "ws_extractions": float(aux["extractions"])}
        params, opt_state = opt.apply(params, grads, state["opt"])
        del grads
        return {"params": params, "opt": opt_state}, out

    return step
