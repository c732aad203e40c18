"""Dense oracle for single-token decode attention (GQA, length-masked);
port of ``repro/kernels/decode_attention/ref.py``."""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, pos, window: int = 0):
    """q: [B, H, hd]; k, v: [B, Hkv, S, hd]; pos: int or 0-d int tensor.

    Attends over slots [0, pos] (and within ``window`` if > 0).
    Returns [B, H, hd] in q's type.
    """
    B, H, hd = q.shape
    S = k.shape[2]
    G = H // k.shape[1]
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * hd ** -0.5
    kpos = torch.arange(S, device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    valid = kpos <= pos
    if window > 0:
        valid &= pos - kpos < window
    s = s.masked_fill(~valid[None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vf).to(q.dtype)
