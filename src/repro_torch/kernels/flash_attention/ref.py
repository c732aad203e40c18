"""Dense oracle for the flash attention kernel (GQA, causal, window); port
of ``repro/kernels/flash_attention/ref.py``."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, H, S, hd]; k, v: [B, Hkv, S, hd].  Materializes the full score
    matrix: an oracle only, O(S^2) memory."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
