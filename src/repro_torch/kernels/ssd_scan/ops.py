"""SSD scan with its gradient (port of ``repro/kernels/ssd_scan/ops.py``).

Forward: the kernel (:func:`.kernel.ssd_scan`: CUDA tensors launch
``csrc/ssd_scan.cu``, CPU tensors run the plain version).  Backward: the
reference's, which recomputes the chunked form
(:func:`repro_torch.models.ssm.ssd_chunked`, numerically the same scan)
and takes its vector-Jacobian product, as ``jax.vjp`` does there: exact
gradients with O(chunk^2) memory.
"""

from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked

from .kernel import ssd_scan as _ssd_scan_kernel


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, _ = _ssd_scan_kernel(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, _ = ssd_chunked(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, inputs, dy.to(y.dtype))
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """x: [b,S,H,P]; dt: [b,S,H]; A: [H]; B,C: [b,S,N] -> y [b,S,H,P], differentiable."""
    return _SSDScan.apply(x, dt, A, B, C, chunk)

