"""Sharding specs of the train state (port of ``repro/launch/specs.py``,
its :func:`opt_state_shardings` so far).

The reference's file also builds ShapeDtypeStruct stand-ins of every
(arch x shape) cell for its dry run; their torch counterparts come with the
dry run's port.  Here the optimizer state's specs follow the parameters',
as GSPMD gives the reference's ZeRO state its layout: ``m`` and ``v``
mirror each parameter's spec, and a factored second moment's ``(row,
col)`` pair drops the reduced dim (the row the last, the column the one
before it).  :func:`repro_torch.checkpoint.restore` takes these spec trees
(``shardings=``) and lays each leaf out as
:func:`repro_torch.models.fsdp.spec_layout` reads its spec.
"""

from __future__ import annotations

from repro_torch.models.sharding import NamedSharding, P
from repro_torch.optim import tree_map


def opt_state_shardings(opt_shapes, p_shard, mesh):
    """Optimizer-state shardings derived from the parameter shardings
    ``p_shard`` (:func:`repro_torch.models.sharding.param_shardings`):
    ``opt_shapes`` is an ``OptState`` (``step``, ``m``, ``v``; a factored
    ``v`` leaf is a ``(row, col)`` pair) of anything with ``.shape``.  The
    step is replicated.  None without parameter shardings."""
    if p_shard is None:
        return None
    rep = NamedSharding(mesh, P())

    def v_like(ps, leaf):
        spec = tuple(ps.spec)
        if isinstance(leaf, tuple):  # factored (row, col)
            spec = spec + (None,) * (len(leaf[0].shape) + 1 - len(spec))
            row = NamedSharding(mesh, P(*spec[:-1][: len(leaf[0].shape)]))
            col_spec = tuple(spec[:-2]) + (spec[-1],)
            col = NamedSharding(mesh, P(*col_spec[: len(leaf[1].shape)]))
            return (row, col)
        spec = spec + (None,) * (len(leaf.shape) - len(spec))
        return NamedSharding(mesh, P(*spec[: len(leaf.shape)]))

    return type(opt_shapes)(step=rep, m=tree_map(v_like, p_shard, opt_shapes.m),
                            v=tree_map(v_like, p_shard, opt_shapes.v))
