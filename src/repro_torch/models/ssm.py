"""Mamba-2 SSD (state-space duality) block in torch ops (port of
``repro/models/ssm.py``): the chunked scan (``_segsum``, ``ssd_chunked``),
the layer for training and prefill (:func:`mamba_train`, optionally with the
cache a decode resumes from) and its one-token decode (:func:`mamba_decode`)
over an :class:`SSMCache`.

As in the reference, the layer runs :func:`ssd_chunked`, not the
``ssd_scan`` kernel (whose backward differentiates :func:`ssd_chunked`).
A sequence longer than ``ssm_chunk`` must be a multiple of it: the scan
raises otherwise, as the reference's assert does.  The projections stay
separate (``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``), and so do the three
depthwise convolutions over x, B and C.
"""

from __future__ import annotations

from functools import reduce
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init


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


def init_mamba(cfg, dtype, *, generator, device, n_layers=None):
    """One Mamba-2 layer's parameters; with ``n_layers`` every tensor gets a
    leading [L] axis (the reference's stacked layout)."""
    d, di, N, H, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    lead = () if n_layers is None else (n_layers,)

    def init(d_in, shape):
        return dense_init(d_in, lead + shape, dtype, generator=generator, device=device)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "w_z": init(d, (d, di)),
        "w_x": init(d, (d, di)),
        "w_B": init(d, (d, N)),
        "w_C": init(d, (d, N)),
        "w_dt": init(d, (d, H)),
        "conv_x": init(W, (W, di)),
        "conv_B": init(W, (W, N)),
        "conv_C": init(W, (W, N)),
        "A_log": full((H,), 0.0, torch.float32),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "norm": full((di,), 0.0, dtype),
        "w_out": init(di, (di, d)),
    }


def _causal_conv(x, w):
    """Depthwise causal conv then SiLU. x: [B, S, C]; w: [W, C]."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return F.silu(out)


def _gated_norm(y, z, weight, eps=1e-6):
    """RMSNorm of ``y * silu(z)`` in its ``1 + weight`` form, the variance
    in fp32 and the result in y's type."""
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y.float() * torch.rsqrt(var + eps)).to(y.dtype) * (1.0 + weight.to(y.dtype))


def _dt(x, p, eq):
    """softplus(x @ w_dt + dt_bias) in fp32."""
    return F.softplus(_einsum(eq, x, p["w_dt"]).float() + p["dt_bias"])


def mamba_train(x, p, cfg, *, return_cache: bool = False):
    """x: [B, S, d] -> [B, S, d] (with ``return_cache`` also the
    :class:`SSMCache` a decode resumes from)."""
    b, S, d = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    z = _einsum("bsd,de->bse", x, p["w_z"])
    raw_x = _einsum("bsd,de->bse", x, p["w_x"])
    raw_B = _einsum("bsd,dn->bsn", x, p["w_B"])
    raw_C = _einsum("bsd,dn->bsn", x, p["w_C"])
    xi = _causal_conv(raw_x, p["conv_x"])
    B_ = _causal_conv(raw_B, p["conv_B"])
    C_ = _causal_conv(raw_C, p["conv_C"])
    dt = _dt(x, p, "bsd,dh->bsh")
    A = -torch.exp(p["A_log"])
    y, final = ssd_chunked(xi.reshape(b, S, H, P), dt, A, B_, C_, cfg.ssm_chunk)
    y = y + xi.reshape(b, S, H, P) * p["D"][None, None, :, None].to(y.dtype)
    y = _gated_norm(y.reshape(b, S, -1), z, p["norm"])
    out = _einsum("bse,ed->bsd", y, p["w_out"]).to(x.dtype)
    if not return_cache:
        return out
    return out, SSMCache(final, *(_last_inputs(r, cfg.ssm_conv_width)
                                  for r in (raw_x, raw_B, raw_C)))


def _last_inputs(raw, W: int):
    """The conv's last W - 1 inputs [B, W-1, C], oldest first; a prompt of
    fewer tokens has zeros before it, as the causal conv reads them."""
    tail = raw[:, -(W - 1):]
    if tail.shape[1] < W - 1:
        tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    return tail


class SSMCache(NamedTuple):
    state: torch.Tensor   # [B, H, P, N] fp32   (stacked caches: [L, B, ...])
    conv_x: torch.Tensor  # [B, W-1, di]
    conv_B: torch.Tensor  # [B, W-1, N]
    conv_C: torch.Tensor  # [B, W-1, N]


def init_ssm_cache(batch, cfg, dtype, *, device, n_layers=None) -> SSMCache:
    """Zeroed decode state; with ``n_layers`` every tensor gets a leading [L] axis."""
    H, P, N, W, di = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv_width, cfg.d_inner
    lead = () if n_layers is None else (n_layers,)

    def zeros(shape, dt):
        return torch.zeros(lead + (batch,) + shape, dtype=dt, device=device)

    return SSMCache(state=zeros((H, P, N), torch.float32), conv_x=zeros((W - 1, di), dtype),
                    conv_B=zeros((W - 1, N), dtype), conv_C=zeros((W - 1, N), dtype))


def _conv_step(x_new, conv_state, w):
    """x_new: [B, C]; conv_state: [B, W-1, C] (previous inputs, oldest first).
    Returns (silu(conv) [B, C], the shifted state)."""
    full = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # [B, W, C]
    out = F.silu(_einsum("bwc,wc->bc", full, w))
    return out, full[:, 1:, :]


def mamba_decode(x, p, cfg, cache: SSMCache):
    """One-token decode. x: [B, 1, d] -> ([B, 1, d], the new SSMCache);
    O(1) in the context length.  The state stays fp32 and is cast to the
    model's type before the product with C, as in the reference."""
    b = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    xt = x[:, 0, :]
    z = _einsum("bd,de->be", xt, p["w_z"])
    xi, cx = _conv_step(_einsum("bd,de->be", xt, p["w_x"]), cache.conv_x, p["conv_x"])
    B_, cb = _conv_step(_einsum("bd,dn->bn", xt, p["w_B"]), cache.conv_B, p["conv_B"])
    C_, cc = _conv_step(_einsum("bd,dn->bn", xt, p["w_C"]), cache.conv_C, p["conv_C"])
    dt = _dt(xt, p, "bd,dh->bh")
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, H, P)
    dA = torch.exp(dt * A)  # [B, H]
    upd = _einsum("bh,bhp,bn->bhpn", dt, xh.float(), B_.float())
    state = cache.state * dA[:, :, None, None] + upd
    y = _einsum("bhpn,bn->bhp", state.to(x.dtype), C_)
    y = y.to(x.dtype) + xh * p["D"][None, :, None].to(x.dtype)
    y = _gated_norm(y.reshape(b, -1), z, p["norm"])
    out = _einsum("be,ed->bd", y, p["w_out"]).to(x.dtype)[:, None, :]
    return out, SSMCache(state, cx, cb, cc)
