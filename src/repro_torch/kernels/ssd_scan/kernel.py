"""Mamba-2 SSD chunked scan: wrapper, CUDA launch and plain version (port of
``repro/kernels/ssd_scan/kernel.py``).

The TPU kernel is ``_ssd_kernel`` in ``ssd_scan``: a grid ``(b, H,
n_chunks)`` with the chunks sequential and the ``[P, N]`` fp32 state in
VMEM scratch.  Per chunk of Q steps, with ``cs = cumsum(dt * A)``:

    y     = (C B^T o L)(x * dt) + exp(cs) o (C S^T),  L[i, j] = exp(cs_i - cs_j), i >= j
    S    <- exp(cs_last) S + ((x * dt) o exp(cs_last - cs))^T B

Here it is ``csrc/ssd_scan.cu``: rows of the state are independent, so one
CTA owns a slice of ``PS`` columns of P of one ``(b, h)`` (the grid
:func:`grid`) and walks the chunks in order with its slice of the state in
registers, every product on tensor cores (``mma.sync`` in bf16 parts,
:func:`split_parts`).  Any shape fits: :func:`plan` shortens the chunk the
kernel walks where the caller's does not fit shared memory, and walks N
past ``NMAX`` in tiles.  :func:`plain_slice_walk` is that walk in torch
ops, slice by slice, with the kernel's chunk, tiles and parts where asked.
For CUDA tensors :func:`ssd_scan` launches the kernel; for CPU tensors it
runs :func:`plain_ssd_scan`, the chunked form in fp32 torch ops.
"""

from __future__ import annotations

import torch

from repro_torch.models.ssm import ssd_chunked

from .._launch import DTYPES, INT, PTR, SMEM_LIMIT, check_contiguous, check_smem, \
    entry_point, launch, runs_plain, stream_of

# csrc/ssd_scan.cu: columns of P a CTA owns, its warps, the widest tile of N
# (16 k-steps of 16), bf16 elements of a row of x dt's parts
PS = 32
WARPS = 4
NMAX = 256
XLD = PS + 8
# bf16 parts (of the input tiles B and C, of every fp32 quantity) and the
# elements padding each B and C row, by input type
PARTS = {torch.bfloat16: (1, 2), torch.float32: (3, 3)}
PAD = {torch.bfloat16: 8, torch.float32: 4}
# the grid's second dimension (b) at most
MAX_GRID_Y = 65535


def _check_shapes(x, dt, A, B, C) -> None:
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


def _check(x, dt, A, B, C, chunk: int) -> int:
    _check_shapes(x, dt, A, B, C)
    S = x.shape[1]
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"S={S} must be a multiple of the chunk {Q}")
    return Q


def _rup16(v: int) -> int:
    return -(-v // 16) * 16


def smem_bytes(Q: int, N: int, dtype=torch.bfloat16, c_aligned: bool = True) -> int:
    """Dynamic shared memory of one CTA of ``csrc/ssd_scan.cu`` walking
    chunks of Q steps and a tile of N columns of N (:func:`plan`): the
    chunk's B tile [Qp][Np + PAD] in the input type, and C's unless
    :func:`c_in_regs`;
    x's IN parts [IN][Qp][XLD] in bf16; one region that holds fp32 inputs'
    raw x [Qp][PS] until it is split, then the state entering the chunk
    [K][PS][Np + 8] in bf16 parts; and dt, cs, dt exp(cs_last - cs) [Qp] in
    fp32 (Qp, Np: Q, N rounded up to 16)."""
    Qp, Np = _rup16(Q), _rup16(N)
    IN, K = PARTS[dtype]
    tiles = 1 if c_in_regs(N, dtype, c_aligned) else 2
    raw = Qp * PS * dtype.itemsize if IN > 1 else 0
    region = max(raw, 2 * K * PS * (Np + 8))
    return (tiles * Qp * (Np + PAD[dtype]) * dtype.itemsize + 2 * IN * Qp * XLD + region
            + 4 * 3 * Qp)


def c_in_regs(N: int, dtype=torch.bfloat16, c_aligned: bool = True) -> bool:
    """Whether the kernel reads C's fragments from global memory straight
    into registers, one 32-bit pair a load, and keeps no C tile: bf16, N
    32, 64 or 128 (widths the kernel is compiled for), C 4-byte aligned
    (``c_aligned``)."""
    return dtype == torch.bfloat16 and N in (32, 64, 128) and c_aligned


def plan(Q: int, N: int, dtype=torch.bfloat16, c_aligned: bool = True):
    """(chunk, tile of N) the kernel walks for the caller's chunk Q: N in
    one tile up to ``NMAX``, else tiles of ``NMAX``; the chunk Q, or the
    longest multiple of 16 below it whose tiles fit ``SMEM_LIMIT`` (at
    least 16, which every tile fits)."""
    nt = min(N, NMAX)
    q = Q
    while q > 16 and smem_bytes(q, nt, dtype, c_aligned) > SMEM_LIMIT:
        q = _rup16(q) - 16
    return q, nt


def grid(b: int, H: int, P: int):
    """The kernel's grid: (ceil(P / PS) * H, b) CTAs of ``WARPS`` warps."""
    return -(-P // PS) * H, b


def occupancy(Q: int, N: int, C: torch.Tensor) -> int:
    """CTAs of the instantiation the launch picks for C's type, N and the
    chunk Q an SM holds at once, as the card reports it
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: registers, shared
    memory and the carveout)."""
    import ctypes

    q, nt = plan(Q, N, C.dtype, C.data_ptr() % 4 == 0)
    fn = entry_point("ssd_scan", "ssd_scan_occupancy", [INT, PTR, INT, INT, INT, PTR])
    out = ctypes.c_int(0)
    err = fn(int(C.dtype == torch.bfloat16), C.data_ptr(), N, q, nt, ctypes.byref(out))
    if err:
        raise RuntimeError(f"ssd_scan occupancy query failed with CUDA error {err}")
    return out.value


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """x: [b, S, H, P]; dt: [b, S, H]; A: [H] (taken as fp32); B, C: [b, S, N].

    Returns (y: [b, S, H, P] in x's type, final_state: [b, H, P, N] fp32).
    CUDA tensors launch ``csrc/ssd_scan.cu`` (contiguous, b up to
    ``MAX_GRID_Y``; the chunk and tiles of :func:`plan`, with an fp32 buffer
    for y's sum where N takes more than one tile); CPU tensors run the
    plain version.
    """
    Q = _check(x, dt, A, B, C, chunk)
    if runs_plain(x, dt, A, B, C):
        return plain_ssd_scan(x, dt, A, B, C, chunk=Q)
    A = A.float().contiguous()
    check_contiguous("ssd_scan", x, dt, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    if b > MAX_GRID_Y:
        raise ValueError(f"ssd_scan: the grid takes b up to {MAX_GRID_Y}: {b}")
    c_aligned = C.data_ptr() % 4 == 0
    q, nt = plan(Q, N, x.dtype, c_aligned)
    check_smem("ssd_scan", smem_bytes(q, nt, x.dtype, c_aligned))
    y = torch.empty_like(x)
    fin = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = torch.empty((b, S, H, P), dtype=torch.float32, device=x.device) if nt < N else None
    _launch_cuda(x, dt, A, B, C, y, fin, ys, Q=q, Nt=nt)
    return y, fin


def _launch_cuda(x, dt, A, B, C, y, fin, ys, *, Q: int, Nt: int) -> None:
    fn = entry_point("ssd_scan", "ssd_scan_launch",
                     # dtype; x, dt, A, B, C, y, fin, ys; b, S, H, P, N, Q, Nt; stream
                     [INT] + [PTR] * 8 + [INT] * 7 + [PTR])
    b, S, H, P = x.shape
    launch("ssd_scan", fn, int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
           A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), fin.data_ptr(),
           0 if ys is None else ys.data_ptr(), b, S, H, P, B.shape[-1], Q, Nt, stream_of(x))


def plain_ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """The plain PyTorch version on any device: the port's
    :func:`~repro_torch.models.ssm.ssd_chunked` on fp32 copies of the
    inputs, y cast back to x's type."""
    Q = _check(x, dt, A, B, C, chunk)
    y, state = ssd_chunked(*(t.float() for t in (x, dt, A, B, C)), chunk=Q)
    return y.to(x.dtype).contiguous(), state


# ---------------------------------------------------------------------------
# the kernel's form in torch ops


def split_parts(v: torch.Tensor, k: int):
    """``v`` as ``k`` bf16 parts (fp32 tensors holding bf16 values): hi =
    bf16(v), then bf16 of each remainder, as the kernel's ``split``."""
    parts = []
    r = v.float()
    for _ in range(k):
        p = r.to(torch.bfloat16).float()
        parts.append(p)
        r = r - p
    return parts


def _product(eq, a, b, ka, kb, km):
    """``einsum(eq, a, b)`` as the kernel's ``mma_parts``: the part products
    (i, j) with i + j < km, smallest first (``ka``, ``kb`` = 0: fp32, no
    parts)."""
    if not ka:
        return torch.einsum(eq, a, b)
    pa, pb = split_parts(a, ka), split_parts(b, kb)
    out = None
    for s in range(km - 1, -1, -1):
        for i in range(ka):
            if 0 <= s - i < kb:
                t = torch.einsum(eq, pa[i], pb[s - i])
                out = t if out is None else out + t
    return out


def plain_slice_walk(x, dt, A, B, C, *, chunk: int = 128, p0: int = 0, ps: int = PS,
                     parts: bool = False, n_tile: int | None = None):
    """The kernel's walk over the chunks for the columns [p0, p0 + ps) of P,
    in torch ops on fp32 copies: per chunk cs = cumsum(dt A), y_off = exp(cs)
    o (C S^T) from the state entering the chunk, y_diag = (C B^T o L o dt) x
    with exp(cs_i - cs_j) taken only where i >= j, then S <- exp(cs_last) S +
    (x o dt exp(cs_last - cs))^T B: dt folded into the fp32 operand, as the
    kernel does.  ``chunk`` is the chunk the kernel walks (:func:`plan`): S
    need not be a multiple of it, the last chunk is then short.  With
    ``n_tile`` the columns of N are walked in tiles of that width, y summed
    over them in fp32.  With ``parts`` each product is the kernel's sum of
    bf16 part products (``PARTS`` of x's type).
    Returns (y [b, S, H, ps'] in x's type, state [b, H, ps', N] fp32), ps'
    the columns of the slice that lie in P."""
    _check_shapes(x, dt, A, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    if Q <= 0:
        raise ValueError(f"chunk must be positive: {chunk}")
    nt = n_tile or N
    cols = slice(p0, min(p0 + ps, P))
    ki, kf = PARTS[x.dtype] if parts else (0, 0)
    xs = x[..., cols].float()
    dtf, Af = dt.float(), A.float()
    y = torch.zeros(xs.shape, dtype=torch.float32, device=x.device)
    states = []
    for n0 in range(0, N, nt):
        Bf, Cf = B[..., n0:n0 + nt].float(), C[..., n0:n0 + nt].float()
        state = torch.zeros((b, H, xs.shape[-1], Bf.shape[-1]), dtype=torch.float32,
                            device=x.device)
        ys = []
        for s0 in range(0, S, Q):
            xc, dtc = xs[:, s0:s0 + Q], dtf[:, s0:s0 + Q]          # [b,q,H,ps], [b,q,H]
            Bc, Cc = Bf[:, s0:s0 + Q], Cf[:, s0:s0 + Q]            # [b,q,n]
            q = xc.shape[1]
            tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[
                None, :, :, None]
            cs = torch.cumsum(dtc * Af, dim=1)                      # [b,q,H]
            yc = _product("bin,bhpn->bihp", Cc, state, ki, kf, kf) * torch.exp(cs)[..., None]
            scores = _product("bin,bjn->bij", Cc, Bc, ki, ki, kf)
            diff = cs[:, :, None, :] - cs[:, None, :, :]            # [b,i,j,H]
            L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
            G = scores[..., None] * L * dtc[:, None]                # dt folded in
            ys.append(yc + _product("bijh,bjhp->bihp", G, xc, kf, ki, kf))
            dd = dtc * torch.exp(cs[:, -1:] - cs)                   # [b,q,H]
            state = (torch.exp(cs[:, -1])[..., None, None] * state
                     + _product("bqhp,bqn->bhpn", xc * dd[..., None], Bc, kf, ki, kf))
        y = y + torch.cat(ys, dim=1)
        states.append(state)
    return y.to(x.dtype), torch.cat(states, dim=-1)
