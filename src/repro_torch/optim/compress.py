"""int8 error-feedback gradient compression (port of ``repro/optim/compress.py``).

A gradient is quantized to int8 with one fp32 scale per tensor
(``max|x| / 127``), and the quantization error is kept as a residual that
the next step adds back before quantizing, so the compression is unbiased
over time (the standard EF-SGD construction).  With ``axis_name`` the int8
payload (as int32), the scale and the rank count are summed over the axis's
process group (``all_reduce`` SUM; :func:`repro_torch.launch.mesh.resolve_axis`),
as the reference's ``psum`` over the pod axis; without a process group that
form raises.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .optimizer import tree_map


def int8_compress_decompress(x: torch.Tensor, axis_name=None):
    """Quantize -> (sum over ``axis_name``) -> dequantize.  Returns ``(value,
    residual)``: ``value`` the dequantized fp32 tensor (with ``axis_name``:
    the summed int8 payload times the ranks' mean scale), ``residual`` the
    local quantization error ``x - q(x)``."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq_local = q.to(torch.float32) * scale
    residual = xf - deq_local
    if axis_name is None:
        return deq_local, residual
    from repro_torch.launch.mesh import resolve_axis

    ax = resolve_axis(axis_name)
    qsum = q.to(torch.int32)
    # the scale and the rank count ride one small sum (a conservative shared scale)
    sn = torch.stack([scale, torch.ones((), dtype=torch.float32, device=xf.device)])
    if ax.group is not None:
        dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=ax.group)
        dist.all_reduce(sn, op=dist.ReduceOp.SUM, group=ax.group)
    return qsum.to(torch.float32) * (sn[0] / sn[1]), residual


def make_ef_compressor(enabled: bool, axis_name=None):
    """Error-feedback wrapper over a gradient tree (a tensor or dict of them).

    Returns ``(init, apply)``: ``init(grads_like)`` the fp32 residual tree,
    ``apply(grads, state) -> (grads', state')``, each leaf through
    :func:`int8_compress_decompress` (summed over ``axis_name`` when given,
    which needs a process group now).  Disabled: the identity with an empty
    state.
    """
    if enabled and axis_name is not None:
        from repro_torch.launch.mesh import resolve_axis

        resolve_axis(axis_name)

    def init(grads_like) -> Any:
        if not enabled:
            return ()
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                        grads_like)

    def apply(grads, state):
        if not enabled:
            return grads, state
        out = tree_map(lambda g, r: int8_compress_decompress(g.to(torch.float32) + r,
                                                             axis_name), grads, state)
        new_g = tree_map(lambda g, o: o[0].to(g.dtype), grads, out)
        new_r = tree_map(lambda g, o: o[1], grads, out)
        return new_g, new_r

    return init, apply
