"""Sharding rules: logical axes -> mesh axes, with divisibility fallback
(port of ``repro/models/sharding.py``).

Logical axes used by the model code:

* ``dp``   — batch / token dim: all data-parallel mesh axes (("pod","data")).
* ``tp``   — tensor-parallel dim (heads / ffn inner / vocab / experts): "model".
* ``fsdp`` — ZeRO-style parameter sharding dim: "data".  The reference leaves
             the re-gathering to GSPMD; the port runs it by hand
             (:mod:`repro_torch.models.fsdp`): each rank keeps its slice of
             every sharded leaf and of its optimizer state, and gathers a
             layer's leaves inside the layer's remat.
* ``fsdp+`` — ``("data", "pod")``: ZeRO across pods too (the 1T-class archs,
             ``fsdp="pods"``).
* ``sp``   — sequence dim of decode KV caches: "model".

A mesh is anything with ``axis_names`` and ``shape`` (``shape[name]`` the
axis size): :class:`repro_torch.launch.mesh.Mesh`, a mesh that only
describes its shape (``make_production_mesh``) or a plain namespace.  A
spec is a :class:`PartitionSpec`: one entry a dim, each ``None``, a mesh
axis name or a tuple of names (the first-named major).

``shard(x, *axes)`` is the identity: in eager torch a rank already holds
only its slice of the batch, so no layout remains to constrain.  The
``use_mesh`` context is what the model code reads instead: under a mesh
with data axes every batch the loss sees is this rank's slice of the
global batch (``dp`` ranks, pod-major), and the quantities that span the
batch (the token mean, the MoE groups and their aux loss, the gradients'
norm) are reduced over those ranks.  No mesh active -> everything is as
on one device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional, Sequence

_STATE = {"mesh": None, "fsdp": False}

LOGICAL = {
    "dp": ("pod", "data"),
    "tp": ("model",),
    "fsdp": ("data",),
    "fsdp+": ("data", "pod"),  # ZeRO across pods too (1T-class archs)
    "sp": ("model",),
}


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (replicated), a mesh axis name, or a tuple
    of names (the dim split over their product, the first-named major; a
    tuple of one name is that name, as JAX's spec reads it).  Fewer entries
    than dims leave the rest replicated; ``P()`` replicates every dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh: what :func:`param_shardings` returns for each leaf."""

    mesh: Any
    spec: PartitionSpec


@contextlib.contextmanager
def use_mesh(mesh, fsdp=False):
    """Make ``mesh`` the active mesh, with fsdp ``False``, ``True`` (ZeRO
    over "data") or ``"pods"`` (over ("data", "pod")), for the block."""
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["fsdp"] = fsdp
    try:
        yield
    finally:
        _STATE.update(prev)


def active_mesh():
    return _STATE["mesh"]


def fsdp_enabled() -> bool:
    return bool(_STATE["fsdp"]) and _STATE["mesh"] is not None


def fsdp_mode():
    """The active fsdp setting (``False``, ``True`` or ``"pods"``); False
    without a mesh."""
    return _STATE["fsdp"] if _STATE["mesh"] is not None else False


def _resolve(axis: Optional[str], dim: int, mesh):
    """Logical axis -> tuple of mesh axes that evenly divide dim (or None)."""
    if axis is None:
        return None
    names = LOGICAL.get(axis, (axis,))
    present = tuple(n for n in names if n in mesh.axis_names)
    if not present:
        return None
    size = math.prod(mesh.shape[n] for n in present)
    if dim % size != 0:
        # try a prefix (e.g. dp=("pod","data") but only "pod" divides)
        for k in range(len(present) - 1, 0, -1):
            size = math.prod(mesh.shape[n] for n in present[:k])
            if dim % size == 0:
                return present[:k]
        return None
    return present if len(present) > 1 else present[0]


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh) -> PartitionSpec:
    assert len(shape) == len(axes), (shape, axes)
    return P(*(_resolve(a, d, mesh) for d, a in zip(shape, axes)))


def shard(x, *axes: Optional[str]):
    """The reference's sharding constraint: the identity here.  A rank's
    tensors are already its own slice (see the module docstring)."""
    return x


# ---------------------------------------------------------------------------
# parameter specs (by tree-path name)

_PARAM_RULES = (
    # (name, logical axes per dim) — <fsdp> resolves to fsdp axis iff enabled.
    ("embed", ("tp", "<fsdp>")),  # [V, d]
    ("unembed", ("<fsdp>", "tp")),  # [d, V]
    ("pos_embed", (None, "<fsdp>")),
    ("wq", ("<fsdp>", "tp", None)),
    ("wk", ("<fsdp>", "tp", None)),
    ("wv", ("<fsdp>", "tp", None)),
    ("wo", ("tp", None, "<fsdp>")),
    ("wdq", ("<fsdp>", None)),
    ("wuq", (None, "tp", None)),
    ("wdkv", ("<fsdp>", None)),
    ("wkr", ("<fsdp>", None)),
    ("wuk", (None, "tp", None)),
    ("wuv", (None, "tp", None)),
    ("wg", ("<fsdp>", "tp")),
    ("wu", ("<fsdp>", "tp")),
    ("wd", ("tp", "<fsdp>")),
    ("router", ("<fsdp>", None)),
    ("we_g", ("tp", "<fsdp>", None)),  # experts = EP over model
    ("we_u", ("tp", "<fsdp>", None)),
    ("we_d", ("tp", None, "<fsdp>")),
    ("ws_g", ("<fsdp>", "tp")),
    ("ws_u", ("<fsdp>", "tp")),
    ("ws_d", ("tp", "<fsdp>")),
    ("w_z", ("<fsdp>", "tp")),
    ("w_x", ("<fsdp>", "tp")),
    ("w_B", ("<fsdp>", None)),
    ("w_C", ("<fsdp>", None)),
    ("w_dt", ("<fsdp>", None)),
    ("conv_x", (None, "tp")),
    ("w_out", ("tp", "<fsdp>")),
)
_RULES = dict(_PARAM_RULES)


def param_spec(path_name: str, shape: Sequence[int], mesh, fsdp, stacked: bool) -> PartitionSpec:
    """Spec for one parameter; `stacked` => leading layer dim (unsharded)."""
    axes = _RULES.get(path_name)
    if axes is None:
        return P()  # norms, biases, small vectors: replicated
    fa = ("fsdp+" if fsdp == "pods" else "fsdp") if fsdp else None
    axes = tuple(fa if a == "<fsdp>" else a for a in axes)
    if stacked:
        axes = (None,) + tuple(axes)
    if len(axes) != len(shape):  # e.g. unstacked variant of a rule
        axes = axes[-len(shape):] if len(axes) > len(shape) else axes + (None,) * (len(shape) - len(axes))
    return spec_for(shape, axes, mesh)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict (``path`` its keys); other
    containers are leaves, as in the parameter trees."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params, mesh, fsdp=False, stacked_prefixes=("layers",)):
    """:class:`NamedSharding` tree for a params tree (anything with ``.shape``
    at the leaves: tensors, meta tensors, shape stand-ins)."""

    def one(path, leaf):
        name = path[-1] if path else ""
        stacked = any(k in stacked_prefixes for k in path)
        return NamedSharding(mesh, param_spec(name, tuple(leaf.shape), mesh, fsdp, stacked))

    return tree_map_with_path(one, params)
