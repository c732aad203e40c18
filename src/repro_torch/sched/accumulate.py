"""Work-stealing gradient accumulation (port of ``repro/sched/accumulate.py``).

One global step = ``max_rounds`` lockstep rounds.  The schedule (who
extracts which microbatch task, per round) comes from the same policy as
``rounds.py``, on the device of ``tails``; it is read to the host once, and
each round's gather indices and weights go to the batch's device.  The
per-task extraction counts make the multiplicity relaxation exact for SGD:
an extraction of task t contributes weight ``1/count_t``, so every task
contributes exactly once, however many workers computed it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import fsdp
from repro_torch.optim import tree_leaves, tree_map

from .rounds import schedule_rounds


def default_max_rounds(n_tasks: int, n_workers: int, mode: str, slack: int = 2) -> int:
    """The reference's round budget of one step: exact redistribution for
    ``ws-mult-ranked``, half the tasks for the deque, every task (head-only
    progress on the worst skew) otherwise."""
    base = -(-n_tasks // n_workers)
    if mode == "ws-mult-ranked":
        return base + slack
    if mode == "ws-wmult-deque":
        return max(base + slack, n_tasks // 2 + slack + 1)
    return n_tasks


def ws_accumulate_grads(loss_fn: Callable[..., torch.Tensor], params: Any, batch: Any,
                        tails: torch.Tensor, *, n_workers: int, mode: str = "ws-wmult",
                        sync_every: int = 1, max_rounds: int | None = None, slack: int = 2,
                        flat_loss: bool = False, acc_dtype: torch.dtype | None = None):
    """Accumulate gradients over one global step with work-stealing rounds.

    Args:
      loss_fn: default contract ``loss_fn(params, micro) -> [n_workers]``
        per-microbatch mean losses, ``micro`` the batch gathered to
        ``[n_workers, ...]``.  With ``flat_loss=True``:
        ``loss_fn(params, flat_micro, row_weights) -> scalar`` where the
        ``flat_micro`` leaves are ``[n_workers*rows, ...]`` and
        ``row_weights = repeat(w, rows) / rows`` sum to the round's weight.
      batch: a tensor or dict of tensors, leading dim n_tasks (the global
        microbatch index).
      tails: ``[n_queues]`` tasks each worker queue owns (sum == n_tasks);
        the schedule runs on its device.
      acc_dtype: the accumulator's dtype.  None (the default) keeps the
        parameters' dtypes, as the reference does; a wider one is asked for
        by name, and the gradients come back in it.

    Returns ``(mean_loss, grads, aux)``: ``grads`` a tree shaped like
    ``params`` in the parameters' dtypes (the accumulator is one such tree,
    as the reference's ``zeros_like(params)``; each round's gradients are
    added into it and freed), and ``aux`` = counts, coverage, extractions,
    loss_weight.  A round whose picks are all -1 has weight 0 and would add
    exact zeros, so it is not run.

    Under a mesh with data axes (``flat_loss`` only) every rank passes the
    whole task batch and computes the same schedule; each round's flat rows
    and their weights are split over the data-parallel ranks, as the
    reference keeps them dp-sharded (a round whose rows do not divide
    raises), and the loss and gradients come back summed over the ranks.
    """
    first = next(tree_leaves(batch))
    n_tasks, dev = first.shape[0], first.device
    if fsdp.dp_size() > 1 and not flat_loss:
        raise ValueError("under a data mesh the rounds' rows are split over the ranks: "
                         "pass flat_loss=True (the train step's contract)")
    if max_rounds is None:
        max_rounds = default_max_rounds(n_tasks, n_workers, mode, slack)
    assignment, counts, _done = schedule_rounds(tails, n_workers, mode, sync_every, max_rounds,
                                                n_tasks)
    ass, cnt = assignment.cpu(), counts.cpu()  # the rounds and their weights: one host read

    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    acc = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    wsum = torch.zeros((), dtype=torch.float32)
    for r in range(ass.shape[0]):
        valid = ass[r] >= 0
        if not bool(valid.any()):
            continue
        safe = torch.clamp(ass[r], min=0)
        # 1/count weighting makes the relaxation exact for the gradient
        w = valid.to(torch.float32) / torch.clamp(cnt[safe], min=1)
        idx = safe.to(device=dev, dtype=torch.int64)
        micro = tree_map(lambda x: x.index_select(0, idx), batch)
        wd = w.to(dev)
        if flat_loss:
            rows = next(tree_leaves(micro)).shape[1]
            flat = tree_map(lambda x: fsdp.dp_rows(x.reshape((-1,) + tuple(x.shape[2:]))),
                            micro)
            loss = loss_fn(params, flat, fsdp.dp_rows(wd.repeat_interleave(rows) / rows))
        else:
            loss = (loss_fn(params, micro) * wd).sum()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        for a, g in zip(acc, grads):
            a.add_(g)
        del grads
        loss_acc += loss.detach()
        wsum += w.sum()
    denom = torch.clamp(wsum, min=1e-6)
    for a in acc:
        a.div_(denom)
    it = iter(acc)
    grads = tree_map(lambda _: next(it), params)
    fsdp.reduce_replicated(params, grads)
    loss_acc = fsdp.dp_sum(loss_acc)
    aux = {"counts": counts, "coverage": (counts > 0).to(torch.float32).mean(),
           "extractions": counts.sum(), "loss_weight": wsum}
    return loss_acc / denom.to(dev), grads, aux
