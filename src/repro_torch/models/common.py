"""Shared building blocks (port of ``repro/models/common.py``): init, RMSNorm
in its ``1 + weight`` form, SwiGLU, RoPE over split halves."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def uniform_init(shape, scale: float, dtype, *, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Uniform(-scale, scale) drawn in fp32 on ``device``, cast to ``dtype``."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.uniform_(-scale, scale, generator=generator)
    return x.to(dtype)


def dense_init(d_in: int, shape, dtype, *, generator, device) -> torch.Tensor:
    return uniform_init(shape, (3.0 / max(d_in, 1)) ** 0.5, dtype,
                        generator=generator, device=device)


def dense_init_slabs(d_in: int, shape, dtype, *, generator, device) -> torch.Tensor:
    """:func:`dense_init` drawn one slab of the last two axes at a time
    (per layer and expert), so the fp32 temporary is one [d, f] slab and not
    the whole tensor: a full-width layer's experts are 33.8 GB in bf16."""
    out = torch.empty(shape, dtype=dtype, device=device)
    slabs = out.view(-1, *shape[-2:])
    buf = torch.empty(shape[-2:], dtype=torch.float32, device=device)
    scale = (3.0 / max(d_in, 1)) ** 0.5
    for slab in slabs:
        slab.copy_(buf.uniform_(-scale, scale, generator=generator))
    return out


def rms_norm(x, weight, eps: float):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dt)


def swiglu(x, wg, wu, wd):
    """SwiGLU MLP: (silu(x@wg) * (x@wu)) @ wd, in the input's dtype."""
    g = torch.einsum("bsd,df->bsf", x, wg)
    u = torch.einsum("bsd,df->bsf", x, wu)
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, wd).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    evens = torch.arange(head_dim // 2, dtype=torch.float32, device=device) * 2.0
    return 1.0 / (theta ** (evens / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] int.  The two halves of hd rotate
    as pairs (x1, x2), as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
