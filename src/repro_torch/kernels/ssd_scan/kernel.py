"""Mamba-2 SSD chunked scan: wrapper, CUDA launch and plain version (port of
``repro/kernels/ssd_scan/kernel.py``).

The TPU kernel is ``_ssd_kernel`` in ``ssd_scan``: a grid ``(b, H,
n_chunks)`` with the chunks sequential and the ``[P, N]`` fp32 state in
VMEM scratch.  Per chunk of Q steps, with ``cs = cumsum(dt * A)``:

    y     = (C B^T o L)(x * dt) + exp(cs) o (C S^T),  L[i, j] = exp(cs_i - cs_j), i >= j
    S    <- exp(cs_last) S + ((x * dt) o exp(cs_last - cs))^T B

Here it is ``csrc/ssd_scan.cu``: one CTA per ``(b, h)`` walks the chunks in
order with the state in shared memory.  For CUDA tensors :func:`ssd_scan`
launches it; for CPU tensors it runs :func:`plain_ssd_scan`, the
chunked form in fp32 torch ops.
"""

from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked

from .._launch import DTYPES, INT, PTR, check_contiguous, check_smem, entry_point, launch, \
    runs_plain, stream_of

# rows of C B^T o L one CTA of csrc/ssd_scan.cu holds at a time
G_ROWS = 32


def _check(x, dt, A, B, C, chunk: int) -> int:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"want x [b, S, H, P], dt [b, S, H], A [H], B, C [b, S, N]: "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, S, H, P = x.shape
    if tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,) or tuple(B.shape[:2]) != (b, S):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)):
        raise ValueError(f"x, dt, B, C must share float32 or bfloat16: "
                         f"{[t.dtype for t in (x, dt, B, C)]}")
    if not A.dtype.is_floating_point:
        raise ValueError(f"A must be floating point: {A.dtype}")
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"S={S} must be a multiple of the chunk {Q}")
    return Q


def smem_bytes(Q: int, P: int, N: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA of ``csrc/ssd_scan.cu``: the state
    [P][N+1], x*dt [Q][P], G_ROWS rows of C B^T o L, four [Q] vectors (fp32),
    and B, C [Q][N + pad] in the input type."""
    ldb = N + (2 if itemsize == 2 else 1)
    return 4 * (P * (N + 1) + Q * P + G_ROWS * Q + 4 * Q) + 2 * Q * ldb * itemsize


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """x: [b, S, H, P]; dt: [b, S, H]; A: [H] (taken as fp32); B, C: [b, S, N].

    Returns (y: [b, S, H, P] in x's type, final_state: [b, H, P, N] fp32).
    CUDA tensors launch ``csrc/ssd_scan.cu`` (contiguous; the chunk's
    working set must fit one CTA's shared memory); CPU tensors run the
    plain version.
    """
    Q = _check(x, dt, A, B, C, chunk)
    if runs_plain(x, dt, A, B, C):
        return plain_ssd_scan(x, dt, A, B, C, chunk=Q)
    A = A.float().contiguous()
    check_contiguous("ssd_scan", x, dt, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    check_smem("ssd_scan", smem_bytes(Q, P, N, x.element_size()))
    y = torch.empty_like(x)
    fin = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    _launch_cuda(x, dt, A, B, C, y, fin, Q=Q)
    return y, fin


def _launch_cuda(x, dt, A, B, C, y, fin, *, Q: int) -> None:
    fn = entry_point("ssd_scan", "ssd_scan_launch",
                     # dtype; x, dt, A, B, C, y, fin; b, S, H, P, N, Q; stream
                     [INT] + [PTR] * 7 + [INT] * 6 + [PTR])
    b, S, H, P = x.shape
    launch("ssd_scan", fn, int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), fin.data_ptr(), b, S, H,
           P, B.shape[-1], Q, stream_of(x))


def plain_ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """The plain PyTorch version on any device: the port's
    :func:`~repro_torch.models.ssm.ssd_chunked` on fp32 copies of the
    inputs, y cast back to x's type."""
    Q = _check(x, dt, A, B, C, chunk)
    y, state = ssd_chunked(*(t.float() for t in (x, dt, A, B, C)), chunk=Q)
    return y.to(x.dtype).contiguous(), state
