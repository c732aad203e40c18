"""Flash attention with its gradient (port of
``repro/kernels/flash_attention/ops.py``).

Forward: the kernel (:func:`.kernel.flash_attention_fwd`: CUDA tensors
launch ``csrc/flash_fwd.cu``, CPU tensors run the plain version).
Backward: the reference's ``_bwd``, the flash backward recomputed from the
saved logsumexp one query chunk at a time, as torch ops: it is jnp in the
reference too, not a Pallas kernel.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_fwd, plain_flash_attention_fwd


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool, window: int, bq: int):
    """(dq, dk, dv) of :func:`flash_attention` in the inputs' types; P is
    recomputed per chunk of ``min(bq, S)`` query rows (O(chunk x S) memory),
    and the GQA query heads' dk, dv are folded back onto their kv heads."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = hd ** -0.5
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    qf, dof = q.float(), do.float()
    D = (dof * out.float()).sum(-1)                       # [B, H, S]
    c = min(bq, S)
    kpos = torch.arange(S, device=q.device)
    qpos_base = torch.arange(c, device=q.device)
    dk = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for q0 in range(0, S, c):
        qb, dob = qf[:, :, q0:q0 + c], dof[:, :, q0:q0 + c]
        lseb, Db = lse[:, :, q0:q0 + c, None], D[:, :, q0:q0 + c, None]
        qpos = q0 + qpos_base
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
        mask = torch.ones((c, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        p = torch.where(mask, torch.exp(s - lseb), torch.zeros_like(s))
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vf)
        ds = p * (dp - Db) * scale
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf))
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qb)
    dq = torch.cat(dqs, dim=2)
    dk = dk.reshape(B, Hkv, G, S, hd).sum(dim=2)
    dv = dv.reshape(B, Hkv, G, S, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk, fwd):
        out, lse = fwd(q, k, v, causal=causal, window=window, bq=bq, bk=bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, bq)
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128):
    """q: [B, H, S, hd]; k, v: [B, Hkv, S, hd] -> [B, H, S, hd], differentiable."""
    return _FlashAttention.apply(q, k, v, causal, window, bq, bk, flash_attention_fwd)


def plain_flash_attention(q, k, v, causal: bool = True, window: int = 0, bq: int = 128,
                          bk: int = 128):
    """:func:`flash_attention` with the plain forward on any device."""
    return _FlashAttention.apply(q, k, v, causal, window, bq, bk, plain_flash_attention_fwd)


def ragged_flash_attention(q, k, v, lengths, *, causal: bool = True, schedule: str = "ws",
                           n_programs: int = 8, bq: int = 32, bk: int = 32,
                           return_stats: bool = False):
    """Ragged (variable-length) flash attention.

    ``schedule="ws"`` routes the imbalanced tile tasks through the
    fence-free work-stealing megakernel (:mod:`repro_torch.pallas_ws`);
    ``schedule="static"`` drains the same queues without stealing, the
    static-grid baseline with identical numerics.
    """
    from repro_torch.pallas_ws.ragged import ragged_flash_attention as _impl

    return _impl(q, k, v, lengths, causal=causal, schedule=schedule, n_programs=n_programs,
                 bq=bq, bk=bk, return_stats=return_stats)
