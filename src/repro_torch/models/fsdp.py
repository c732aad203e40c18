"""ZeRO-style sharding run by hand over the ranks of a ``torch.distributed``
mesh: the work that GSPMD does for the reference's ``fsdp`` specs
(``repro/models/sharding.py``), which has no file of its own there.

* :func:`shard_params` keeps this rank's slice of every leaf along the dim
  that its spec (:func:`repro_torch.models.sharding.param_spec`) gives to
  the fsdp axes.  A dim split over two axes (``fsdp+`` = ("data", "pod"))
  is laid out with the first-named axis major, as GSPMD lays it out; a
  leaf whose spec names no axis larger than 1 (norms, biases, small
  vectors, or a dim that does not divide) stays whole.  A sharded leaf
  carries its :class:`Layout` as the tensor attribute ``zero_layout``;
  the optimizer's state made from it inherits it (``m`` and ``v`` mirror
  the leaf, a factored ``v``'s row and column drop the reduced dim, as
  ``repro/launch/specs.py``'s ``opt_state_shardings`` derives them).
* :func:`gathered` is an autograd Function: an all-gather along the
  leaf's dim in the forward, a reduce-scatter (the sum over the fsdp
  ranks) of its gradient in the backward, then an all-reduce over the
  data axes the leaf is not split over.  The leaves of the tree are the
  shards themselves, so ``torch.autograd.grad`` returns gradients in the
  shards' shapes.  The model gathers a layer inside the function that
  ``torch.utils.checkpoint`` replays, so the gathered weights live only
  inside their layer; the gather runs again in the replay.
* A leaf that several remat scopes read (the hybrid's ``shared_attn``)
  goes through :func:`share` once, outside them, and :func:`fetch` inside
  each: the gradients of every use are summed before the one
  reduce-scatter.
* :func:`reduce_replicated` all-reduces the gradients of the leaves
  without a layout over the data axes: with ``fsdp=False`` that is plain
  data parallelism (every leaf replicated).
* Global quantities of the batch: :func:`dp_sum` (the loss's token count,
  the ws rounds' weight), :func:`moe_group` (the MoE groups come from the
  global token count; each rank holds whole groups).

Reductions of bf16 gradients sum in fp32: each rank's partial gradient is
widened, reduce-scattered (or all-reduced) and rounded back to the
parameter's dtype once.  Against the same step on one rank that adds one
rounding of each rank's partial sum, so a bf16 step differs from the
one-rank step by about one bf16 ulp of each partial gradient.

Every rank must issue the same collectives in the same order: every leaf
is gathered, reduced and counted by every rank, and nothing here depends
on a rank's data.  ``"model"`` axes larger than 1 (tensor parallelism)
are not run: :func:`check_mesh` raises.  gloo reduces, gathers and
scatters CUDA tensors itself (through the host), so on one card several
ranks share it (:mod:`repro_torch.launch.mesh`); a collective's parts go
at once over the axis's lanes (more groups of the same ranks), since one
gloo group moves its bytes on one set of connections.  :data:`STATS`
counts the bytes each rank moves.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .sharding import LOGICAL, active_mesh, param_shardings

LAYOUT_ATTR = "zero_layout"

# bytes this rank moved since the last reset (what an ideal ring sends):
# all-gathers (n - 1) shards, reduce-scatters (n - 1) fp32 shards,
# all-reduces the reduced tensor's bytes
STATS = {"gathered": 0, "reduce_scattered": 0, "all_reduced": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class Layout(NamedTuple):
    """A sharded leaf: ``dim`` split over the mesh axes ``axes`` (major
    first, each larger than 1) out of ``full`` entries."""

    dim: int
    axes: Tuple[str, ...]
    full: int


def layout_of(t) -> Optional[Layout]:
    return getattr(t, LAYOUT_ATTR, None)


def set_layout(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    if layout is not None:
        setattr(t, LAYOUT_ATTR, layout)
    return t


def has_layouts(tree) -> bool:
    """True if any leaf of the nested dict ``tree`` is a shard."""
    if isinstance(tree, dict):
        return any(has_layouts(v) for v in tree.values())
    return layout_of(tree) is not None


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def check_mesh(mesh) -> None:
    """Raise for a mesh axis the port does not run: ``"model"`` over 1."""
    if mesh is not None and "model" in mesh.axis_names and mesh.shape["model"] > 1:
        raise NotImplementedError(
            f"mesh {dict(mesh.shape)}: a 'model' axis of {mesh.shape['model']} asks for tensor "
            "parallelism (the 'tp' and 'sp' specs), which the port does not run; use a "
            "('data', 'model') mesh with model 1")


def spec_layout(spec, shape, mesh) -> Optional[Layout]:
    """The :class:`Layout` a spec gives a leaf of ``shape`` on ``mesh``, or
    None if no dim is split over an axis larger than 1."""
    check_mesh(mesh)
    split = []
    for dim, entry in enumerate(tuple(spec)):
        axes = tuple(a for a in _entry_axes(entry) if mesh.shape[a] > 1)
        if axes:
            split.append(Layout(dim, axes, int(shape[dim])))
    if len(split) > 1:
        raise NotImplementedError(f"spec {spec} splits {len(split)} dims; the port's ZeRO "
                                  "layout splits one")
    return split[0] if split else None


def _mesh():
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("ZeRO-sharded parameters need the mesh they were sharded on: "
                           "run under repro_torch.models.sharding.use_mesh(mesh, fsdp=...)")
    return mesh


def _n(axes, mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _index(axes, mesh) -> int:
    """This rank's chunk along a dim split over ``axes`` (first-named major)."""
    idx = 0
    for a in axes:
        ax = mesh.axis(a)
        idx = idx * ax.size + ax.index
    return idx


def dp_axes(mesh=None) -> Tuple[str, ...]:
    """The data-parallel axes of the active mesh larger than 1, pod first."""
    mesh = active_mesh() if mesh is None else mesh
    if mesh is None:
        return ()
    return tuple(a for a in LOGICAL["dp"] if a in mesh.axis_names and mesh.shape[a] > 1)


def dp_size() -> int:
    """Data-parallel ranks of the active mesh (1 without one)."""
    mesh = active_mesh()
    return _n(dp_axes(mesh), mesh) if mesh is not None else 1


def dp_index() -> int:
    """This rank's place among the data-parallel ranks (pod-major, as the
    reference's ``dp`` = ("pod", "data") splits the batch)."""
    mesh = active_mesh()
    return _index(dp_axes(mesh), mesh) if mesh is not None else 0


def dp_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's slice of a global batch leaf along ``dim``."""
    n = dp_size()
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split over {n} data-parallel ranks")
    return x.chunk(n, dim)[dp_index()]


def _lanes(ax, n: int):
    """The groups to split a collective of ``n`` slices over: the axis's
    group and its lanes, no more than there are slices."""
    return ((ax.group,) + tuple(ax.lanes))[:max(1, n)]


def _wait(works) -> None:
    for w in works:
        w.wait()


def _all_reduce(t: torch.Tensor, axes) -> torch.Tensor:
    """Sum ``t`` (contiguous) in place over the ranks of ``axes`` (one axis
    at a time; its parts at once over the axis's lanes)."""
    mesh = _mesh()
    for a in axes:
        ax = mesh.axis(a)
        if ax.size > 1:
            flat = t.view(-1)
            parts = flat.chunk(len(_lanes(ax, flat.numel())))
            _wait([dist.all_reduce(p, group=g, async_op=True)
                   for p, g in zip(parts, _lanes(ax, flat.numel()))])
            STATS["all_reduced"] += t.numel() * t.element_size()
    return t


@torch.no_grad()
def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (detached, fp32) summed over the data-parallel ranks; ``x``
    itself without a data mesh."""
    axes = dp_axes()
    if not axes:
        return x
    return _all_reduce(x.detach().float().clone(), axes)


def moe_group(tokens: int, group_size: int) -> int:
    """The MoE routing group of a rank's ``tokens``: the reference groups the
    global batch, ``min(group_size, T)`` of its T tokens, so under a data
    mesh ``g`` comes from the global count and each rank must hold whole
    groups (``min(group_size, tokens)`` without one)."""
    n = dp_size()
    if n == 1:
        return min(group_size, tokens)
    g = min(group_size, tokens * n)
    if tokens % g:
        raise ValueError(
            f"a MoE routing group is min(group_size={group_size}, global tokens) = {g} tokens "
            f"of the {tokens * n}-token global batch ({tokens} a rank on {n} data-parallel "
            "ranks); a group may not split across ranks, so each rank must hold whole groups")
    return g


# ---------------------------------------------------------------------------
# gather and reduce-scatter along one dim


def _gather_rows(src: torch.Tensor, ax) -> torch.Tensor:
    """All-gather ``src`` [s, ...] over an axis: [n s, ...], rank-major.
    The rows are split over the axis's lanes, each part gathered at once."""
    n, rest = ax.size, tuple(src.shape[1:])
    groups = _lanes(ax, src.shape[0])
    parts = src.chunk(len(groups))
    outs = [p.new_empty((n * p.shape[0],) + rest) for p in parts]
    _wait([dist.all_gather_into_tensor(o, p, group=g, async_op=True)
           for o, p, g in zip(outs, parts, groups)])
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.view((n, -1) + rest) for o in outs], dim=1).view((-1,) + rest)


def _scatter_rows(src: torch.Tensor, ax) -> torch.Tensor:
    """Reduce-scatter ``src`` [n s, ...] over an axis: this rank's [s, ...]
    of the sum, split over the axis's lanes like :func:`_gather_rows`."""
    n, rest = ax.size, tuple(src.shape[1:])
    rows = src.view((n, -1) + rest)
    groups = _lanes(ax, rows.shape[1])
    parts = rows.chunk(len(groups), dim=1)
    outs = [p.new_empty(tuple(p.shape[1:])) for p in parts]
    _wait([dist.reduce_scatter_tensor(o, p.contiguous().view((-1,) + rest), group=g, async_op=True)
           for o, p, g in zip(outs, parts, groups)])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _gather(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """All-gather a shard along ``dim`` over ``axes`` (minor axis first,
    so the chunks land first-named major)."""
    for a in reversed(axes):
        ax = mesh.axis(a)
        src = x.movedim(dim, 0).contiguous()
        out = _gather_rows(src, ax)
        STATS["gathered"] += (ax.size - 1) * src.numel() * src.element_size()
        x = out.movedim(0, dim)
    return x.contiguous()


def _scatter(g: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """Reduce-scatter a full gradient along ``dim`` over ``axes`` (the
    major axis first): this rank's chunk of the sum over those ranks."""
    for a in axes:
        ax = mesh.axis(a)
        out = _scatter_rows(g.movedim(dim, 0).contiguous(), ax)
        STATS["reduce_scattered"] += (ax.size - 1) * out.numel() * out.element_size()
        g = out.movedim(0, dim)
    return g


def _reduce_grad(g: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """The shard's gradient: the full gradient summed in fp32 over every
    data-parallel rank, this rank's chunk of it, in ``g``'s dtype."""
    g32 = _scatter(g.float(), dim, axes, mesh)
    rest = tuple(a for a in dp_axes(mesh) if a not in axes)
    return _all_reduce(g32.contiguous(), rest).to(g.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, axes):
        mesh = _mesh()
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        return _gather(shard, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce_grad(g, ctx.dim, ctx.axes, ctx.mesh), None, None


def gathered(t: torch.Tensor) -> torch.Tensor:
    """The whole of leaf ``t`` (``t`` itself if it is not a shard)."""
    lay = layout_of(t)
    return t if lay is None else _Gather.apply(t, lay.dim, lay.axes)


def layer_slice(v: torch.Tensor, idx: int) -> torch.Tensor:
    """Layer ``idx`` of a stacked leaf: a view (no layout), the layer's
    slice gathered (split below the layer dim), or the leaf gathered and
    then sliced (split along the layer dim itself, as the reference's
    rules split an unstacked leaf's first dim)."""
    lay = layout_of(v)
    if lay is None:
        return v[idx]
    if lay.dim >= 1:
        return _Gather.apply(v[idx], lay.dim - 1, lay.axes)
    return _Gather.apply(v, 0, lay.axes)[idx]


class _Stand(torch.autograd.Function):
    """A shard -> a stride-0 stand-in of the whole leaf.  Every use's
    gradient flows into the stand-in and is summed there; the backward
    reduce-scatters that sum once."""

    @staticmethod
    def forward(ctx, shard, dim, axes):
        mesh = _mesh()
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        full = list(shard.shape)
        full[dim] *= _n(axes, mesh)
        return shard.new_zeros(()).expand(full)

    @staticmethod
    def backward(ctx, g):
        return _reduce_grad(g, ctx.dim, ctx.axes, ctx.mesh), None, None


class _Fetch(torch.autograd.Function):
    """(stand-in, shard) -> the gathered leaf; its gradient goes to the
    stand-in unreduced."""

    @staticmethod
    def forward(ctx, stand, shard, dim, axes):
        return _gather(shard, dim, axes, _mesh())

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def share(tree):
    """Stand-ins for the leaves of ``tree`` that several remat scopes read:
    call once, outside them; :func:`fetch` inside each."""
    if isinstance(tree, dict):
        return {k: share(v) for k, v in tree.items()}
    lay = layout_of(tree)
    stand = None if lay is None else _Stand.apply(tree, lay.dim, lay.axes)
    return (stand, tree)


def fetch(shared, idx: Optional[int] = None):
    """The leaves of a :func:`share` tree, gathered (and ``[idx]`` of each)."""
    if isinstance(shared, dict):
        return {k: fetch(v, idx) for k, v in shared.items()}
    stand, v = shared
    if stand is not None:
        lay = layout_of(v)
        v = _Fetch.apply(stand, v, lay.dim, lay.axes)
    return v if idx is None else v[idx]


# ---------------------------------------------------------------------------
# trees


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn: Callable, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def take_shard(full: torch.Tensor, layout: Optional[Layout], mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf under ``layout`` (a contiguous
    copy carrying the layout), or the leaf itself if it has none."""
    if layout is None:
        return full
    n = _n(layout.axes, mesh)
    chunk = full.shape[layout.dim] // n
    part = full.narrow(layout.dim, _index(layout.axes, mesh) * chunk, chunk)
    return set_layout(part.clone(memory_format=torch.contiguous_format), layout)


def shard_params(params, mesh, fsdp) -> Dict[str, Any]:
    """This rank's ZeRO shard of a whole parameter tree under the reference's
    specs on ``mesh`` (``fsdp`` False, True or ``"pods"``).  Every rank
    must pass the same tree.  The whole leaves are not kept."""
    check_mesh(mesh)
    specs = param_shardings(params, mesh, fsdp=fsdp)
    return _map2(lambda leaf, sh: take_shard(leaf, spec_layout(sh.spec, leaf.shape, mesh),
                                             mesh), params, specs)


@torch.no_grad()
def unshard(t: torch.Tensor) -> torch.Tensor:
    """A shard gathered whole on every rank (``t`` itself if it is not one)."""
    lay = layout_of(t)
    return t if lay is None else _gather(t, lay.dim, lay.axes, _mesh())


def unshard_params(tree):
    """Every leaf of a tree gathered whole on every rank (the same tree on each)."""
    return _map(unshard, tree)


def with_layouts(grads, params):
    """``grads`` with each leaf carrying its parameter's layout (the
    gradient of a shard is a shard alike), e.g. to :func:`unshard_params`."""
    return _map2(lambda g, p: set_layout(g, layout_of(p)), grads, params)


@torch.no_grad()
def reduce_replicated(params, grads) -> None:
    """All-reduce, in place and in fp32, the gradient of every leaf that is
    not a shard over the data-parallel ranks (a shard's gradient was
    reduced in its gather's backward)."""
    axes = dp_axes()
    if not axes:
        return

    def one(p, g):
        if layout_of(p) is None:
            g.copy_(_all_reduce(g.float(), axes))

    _map2(one, params, grads)


def factored_layouts(layout: Optional[Layout], ndim: int):
    """(row, col) layouts of a factored second moment of a leaf with
    ``ndim`` dims: the row drops the last dim, the column the one before."""
    if layout is None:
        return None, None
    row = None if layout.dim == ndim - 1 else layout
    if layout.dim == ndim - 2:
        col = None
    elif layout.dim == ndim - 1:
        col = Layout(ndim - 2, layout.axes, layout.full)
    else:
        col = layout
    return row, col


def sum_over(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` summed in place over the ranks of the mesh ``axes`` (those that
    split a leaf: a layout's ``axes``)."""
    return _all_reduce(t, axes)
