"""The SSD (Mamba-2) chunked scan in torch ops (port of the scan half of
``repro/models/ssm.py``: ``_segsum`` and ``ssd_chunked``).  The SSD scan
kernel's backward differentiates :func:`ssd_chunked`; the Mamba-2 layer
and its caches are not ported yet."""

from __future__ import annotations

from functools import reduce

import torch


def _einsum(eq, *ops):
    """``torch.einsum`` on operands promoted to one type, as jnp.einsum
    promotes (bf16 with fp32 computes in fp32)."""
    dtype = reduce(torch.promote_types, [o.dtype for o in ops])
    return torch.einsum(eq, *[o.to(dtype) for o in ops])


def _segsum(dA):
    """dA: [..., q] -> [..., q, q] lower-triangular segment sums
    (``ss[i, j] = sum(dA[j+1..i])``, -inf above the diagonal)."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, ss, torch.full_like(ss, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD scan. x: [B,S,H,P]; dt: [B,S,H]; A: [H]; B,C: [B,S,N] (1 group).

    Returns (y: [B,S,H,P] in x's type, final_state: [B,H,P,N] fp32).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    c = S // Q
    if c * Q != S:
        raise ValueError(f"S={S} must be a multiple of the chunk {Q}")
    xr = x.reshape(b, c, Q, H, P)
    dtr = dt.reshape(b, c, Q, H)
    Br = B.reshape(b, c, Q, N)
    Cr = C.reshape(b, c, Q, N)

    xdt = xr * dtr[..., None]                     # discretized input
    dA = dtr * A                                  # [b,c,Q,H]
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # [b,c,H,Q,Q]
    scores = _einsum("bcin,bcjn->bcij", Cr, Br)
    y_diag = _einsum("bcij,bchij,bcjhp->bcihp", scores, L, xdt)

    # per-chunk end states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [b,c,Q,H]
    states = _einsum("bcqn,bcqh,bcqhp->bchpn", Br, decay_states, xdt)

    # inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])   # [b,c,H]
    s = (init_state if init_state is not None
         else torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device))
    prev = []
    for ci in range(c):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci].float()
    prev = torch.stack(prev, dim=1).to(x.dtype)   # state entering chunk ci

    # state -> output within each chunk
    state_decay = torch.exp(dA_cs)                # [b,c,Q,H]
    y_off = _einsum("bcqn,bchpn,bcqh->bcqhp", Cr, prev, state_decay)
    y = (y_diag + y_off).reshape(b, S, H, P).to(x.dtype)
    return y, s
