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

ZeRO shards (``repro_torch.models.fsdp``): ``init`` gives each state
tensor its parameter's layout (a factored pair's row and column drop the
reduced dim), the global norm sums each shard's squares over the ranks
that split its leaf and counts a replicated leaf once, and a factored
second moment whose reduced dim is split takes its means over the whole
leaf.  AdamW is elementwise and needs nothing else.
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


def _layout(p):
    return getattr(p, "zero_layout", None)


@torch.no_grad()
def global_norm(tree, params=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, a slice at a time.
    With ``params`` (the tree's parameters) a ZeRO shard's squares are
    summed over the ranks that split its leaf."""
    if params is not None and any(_layout(p) is not None for p in tree_leaves(params)):
        return _sharded_norm(tree, params)
    total = None
    for leaf in tree_leaves(tree):
        # a tied embedding's gradient (its lookup's plus its transpose's) may
        # come back non-contiguous
        for s in _slices(leaf.contiguous()):
            sq = s.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _sharded_norm(tree, params) -> torch.Tensor:
    from repro_torch.models import fsdp

    parts = {}  # the split axes (() replicated) -> this rank's sum of squares
    for g, p in zip(tree_leaves(tree), tree_leaves(params)):
        lay = _layout(p)
        key = () if lay is None else lay.axes
        for s in _slices(g.contiguous()):
            sq = s.float().square().sum()
            parts[key] = sq if key not in parts else parts[key] + sq
    total = parts.pop((), None)
    for key in sorted(parts):  # the same collectives in the same order on every rank
        part = fsdp.sum_over(parts[key], key)
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, params=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale, norm)``: the factor ``min(1, max_norm / norm)`` that the
    reference multiplies into an fp32 copy of every grad.  The port applies
    it inside each tensor's update instead of materialising that copy."""
    norm = global_norm(grads, params)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _zeros(p, shape, dtype, layout):
    """A zero state tensor carrying ``layout`` (a shard's, or None)."""
    t = torch.zeros(shape, dtype=dtype, device=p.device)
    if layout is not None:
        t.zero_layout = layout
    return t


def make_adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm=1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: _zeros(p, p.shape, torch.float32, _layout(p))  # noqa: E731
        return OptState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def apply(params, grads, state):
        scale, _ = clip_by_global_norm(grads, clip_norm, params)
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
        from repro_torch.models.fsdp import factored_layouts

        def v_init(p):
            if _factored(p):
                row, col = factored_layouts(_layout(p), p.dim())
                return (_zeros(p, p.shape[:-1], torch.float32, row),
                        _zeros(p, p.shape[:-2] + p.shape[-1:], torch.float32, col))
            return _zeros(p, p.shape, torch.float32, _layout(p))

        return OptState(step=0,
                        m=tree_map(lambda p: _zeros(p, p.shape, torch.bfloat16, _layout(p)),
                                   params),
                        v=tree_map(v_init, params))

    @torch.no_grad()
    def apply(params, grads, state):
        scale, _ = clip_by_global_norm(grads, clip_norm, params)
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
            lay = _layout(p)
            if lay is not None and lay.dim >= p.dim() - 2:
                _split_factored(p, g, m, vr, vc, scale, lay, update, dec)
                return
            # one [r, c] slab of the leading dims at a time
            for ps, gs, ms, vrs, vcs in zip(p.view(-1, r, c), g.view(-1, r, c),
                                            m.view(-1, r, c), vr.view(-1, r), vc.view(-1, c)):
                g32 = gs.float() * scale
                g2 = g32.square() + eps
                vrs.mul_(decay).add_((1 - decay) * g2.mean(-1))
                vcs.mul_(decay).add_((1 - decay) * g2.mean(-2))
                denom = torch.clamp(vrs.mean(-1, keepdim=True), min=eps)
                update(ps, g32, ms, vrs[:, None] * vcs[None, :] / denom, dec)

        def _split_factored(p, g, m, vr, vc, scale, lay, update, dec):
            """A shard split along a reduced dim (rows r or columns c): the
            slabs' sums of squares first, summed over the ranks that split
            the leaf in one collective, then the update, slab by slab."""
            from repro_torch.models import fsdp

            r, c = p.shape[-2:]
            rows = lay.dim == p.dim() - 2  # else the columns are split
            sums = torch.empty((p.numel() // (r * c), c if rows else r), dtype=torch.float32,
                               device=p.device)
            for gs, out in zip(g.view(-1, r, c), sums):
                g2 = (gs.float() * scale).square() + eps
                out.copy_(g2.sum(-2) if rows else g2.sum(-1))
            means = fsdp.sum_over(sums, lay.axes) / lay.full
            denoms = torch.empty(sums.shape[0], dtype=torch.float32, device=p.device)
            for i, (gs, vrs, vcs) in enumerate(zip(g.view(-1, r, c), vr.view(-1, r),
                                                   vc.view(-1, c))):
                g2 = (gs.float() * scale).square() + eps
                vrs.mul_(decay).add_((1 - decay) * (means[i] if not rows else g2.mean(-1)))
                vcs.mul_(decay).add_((1 - decay) * (means[i] if rows else g2.mean(-2)))
                denoms[i] = vrs.sum(-1)
            if rows:  # vr is split: its mean over the rows spans the ranks
                fsdp.sum_over(denoms, lay.axes)
            denoms = torch.clamp(denoms / (lay.full if rows else r), min=eps)
            for ps, gs, ms, vrs, vcs, dn in zip(p.view(-1, r, c), g.view(-1, r, c),
                                                m.view(-1, r, c), vr.view(-1, r),
                                                vc.view(-1, c), denoms):
                g32 = gs.float() * scale
                update(ps, g32, ms, vrs[:, None] * vcs[None, :] / dn, dec)

        tree_map(upd, params, grads, state.m, state.v)
        return params, OptState(step=state.step + 1, m=state.m, v=state.v)

    return Optimizer(init, apply)
