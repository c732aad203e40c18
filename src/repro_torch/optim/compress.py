"""int8 error-feedback gradient compression (port of ``repro/optim/compress.py``).

A gradient is quantized to int8 with one fp32 scale per tensor
(``max|x| / 127``), and the quantization error is kept as a residual that
the next step adds back before quantizing, so the compression is unbiased
over time (the standard EF-SGD construction).  In the reference the int8
payload is what crosses the cross-pod links in a ``psum``; that
``axis_name`` form belongs to the mesh port and raises here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .optimizer import tree_map

_MESH = "the axis_name (psum) form belongs to the mesh port (ROADMAP queue 1 item 6)"


def int8_compress_decompress(x: torch.Tensor, axis_name: Optional[str] = None):
    """Quantize -> dequantize.  Returns ``(value, residual)``: ``value`` the
    dequantized fp32 tensor, ``residual`` the local quantization error
    ``x - q(x)``."""
    if axis_name is not None:
        raise NotImplementedError(f"int8_compress_decompress: {_MESH}")
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    value = q.to(torch.float32) * scale
    return value, xf - value


def make_ef_compressor(enabled: bool, axis_name: Optional[str] = None):
    """Error-feedback wrapper over a gradient tree (a tensor or dict of them).

    Returns ``(init, apply)``: ``init(grads_like)`` the fp32 residual tree,
    ``apply(grads, state) -> (grads', state')``.  Disabled: the identity with
    an empty state.
    """
    if enabled and axis_name is not None:
        raise NotImplementedError(f"make_ef_compressor: {_MESH}")

    def init(grads_like) -> Any:
        if not enabled:
            return ()
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                        grads_like)

    def apply(grads, state):
        if not enabled:
            return grads, state
        out = tree_map(lambda g, r: int8_compress_decompress(g.to(torch.float32) + r), grads,
                       state)
        new_g = tree_map(lambda g, o: o[0].to(g.dtype), grads, out)
        new_r = tree_map(lambda g, o: o[1], grads, out)
        return new_g, new_r

    return init, apply
