"""Optimizers (port of ``repro/optim/optimizer.py``): AdamW with fp32
states and the bf16-momentum, factored-second-moment variant, both with
decoupled weight decay and global-norm clipping.

The update math is the reference's, but the port applies it in place, one
tensor at a time and in slices of at most ``CHUNK`` elements: the reference's
``clip_by_global_norm`` maps the whole grad tree to fp32 and its update
builds new trees, and at full width one fp32 copy of deepseek-v2's grads
(one layer, 5.02 B parameters) is 20 GB the card does not have beside the
weights and AdamW's 40 GB of states.  Here the norm is summed tensor by
tensor, its clip scale is applied inside each tensor's update, and no
fp32 temporary exceeds one slice.

Trees are nested dicts of tensors (the parameter layout); ``apply(params,
grads, state)`` updates ``params`` and ``state`` in place and returns them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, NamedTuple, Tuple

import torch

# elements per fp32 slice of an update (256 MB)
CHUNK = 1 << 26


class OptState(NamedTuple):
    step: int
    m: Any
    v: Any  # adamw: a tensor per parameter; factored: (row, col) for >= 2-D ones


class Optimizer(NamedTuple):
    init: Callable[[Any], OptState]
    apply: Callable[[Any, Any, OptState], Tuple[Any, OptState]]


def tree_leaves(tree) -> Iterator:
    """The tensors of a nested dict in insertion order (tuples are leaves)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _slices(t: torch.Tensor):
    """Views of at most CHUNK elements over a contiguous tensor (writes
    through them land in ``t``)."""
    return t.view(-1).split(CHUNK)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, a slice at a time."""
    total = None
    for leaf in tree_leaves(tree):
        for s in _slices(leaf):
            sq = s.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale, norm)``: the factor ``min(1, max_norm / norm)`` that the
    reference multiplies into an fp32 copy of every grad.  The port applies
    it inside each tensor's update instead of materialising that copy."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def make_adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm=1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return OptState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def apply(params, grads, state):
        scale, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = lr(step)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step

        def upd(p, g, m, v):
            decay = weight_decay if p.dim() >= 2 else 0.0
            g = g.contiguous()
            for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
                g32 = gs.float() * scale
                ms.mul_(b1).add_((1 - b1) * g32)
                vs.mul_(b2).add_((1 - b2) * g32.square())
                u = (ms / bc1) / (torch.sqrt(vs / bc2) + eps)
                p32 = ps.float()
                ps.copy_(p32 - lr_t * (u + decay * p32))

        tree_map(upd, params, grads, state.m, state.v)
        return params, OptState(step=step, m=state.m, v=state.v)

    return Optimizer(init, apply)


def _factored(p) -> bool:
    return p.dim() >= 2


def make_adafactor_momentum(lr: Callable, *, b1=0.9, decay=0.99, eps=1e-30,
                            weight_decay=0.1, clip_norm=1.0) -> Optimizer:
    """bf16 momentum + second moment factored over the last two dims (row
    and column means), as the reference's."""

    def init(params):
        def v_init(p):
            if _factored(p):
                return (torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                    device=p.device))
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return OptState(step=0,
                        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                                         device=p.device), params),
                        v=tree_map(v_init, params))

    @torch.no_grad()
    def apply(params, grads, state):
        scale, _ = clip_by_global_norm(grads, clip_norm)
        lr_t = lr(state.step + 1)

        def update(p, g, m, vhat, dec):
            u = g / torch.sqrt(vhat + eps)
            mf = b1 * m.float() + (1 - b1) * u
            p32 = p.float()
            p.copy_(p32 - lr_t * (mf + dec * p32))
            m.copy_(mf)

        def upd(p, g, m, v):
            dec = weight_decay if p.dim() >= 2 else 0.0
            g = g.contiguous()
            if not _factored(p):
                g32 = g.float() * scale
                v.mul_(decay).add_((1 - decay) * (g32.square() + eps))
                update(p, g32, m, v, dec)
                return
            vr, vc = v
            r, c = p.shape[-2:]
            # one [r, c] slab of the leading dims at a time
            for ps, gs, ms, vrs, vcs in zip(p.view(-1, r, c), g.view(-1, r, c),
                                            m.view(-1, r, c), vr.view(-1, r), vc.view(-1, c)):
                g32 = gs.float() * scale
                g2 = g32.square() + eps
                vrs.mul_(decay).add_((1 - decay) * g2.mean(-1))
                vcs.mul_(decay).add_((1 - decay) * g2.mean(-2))
                denom = torch.clamp(vrs.mean(-1, keepdim=True), min=eps)
                update(ps, g32, ms, vrs[:, None] * vcs[None, :] / denom, dec)

        tree_map(upd, params, grads, state.m, state.v)
        return params, OptState(step=state.step + 1, m=state.m, v=state.v)

    return Optimizer(init, apply)
