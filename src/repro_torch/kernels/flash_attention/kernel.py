"""Flash attention forward: wrapper, CUDA launch and plain version (port of
``repro/kernels/flash_attention/kernel.py``).

The TPU kernel is ``_fwd_kernel`` in ``flash_attention_fwd``: a grid
``(B, H, nq, nk)`` with the k sweep sequential, the online-softmax state
(running max, sum, accumulator) in VMEM scratch, causal and sliding-window
masks inside the block, fully masked block pairs skipped, and GQA mapped by
``h // G``.  Here it is ``csrc/flash_fwd.cu``: one CTA per
``(b, h, q-tile)`` whose loop over the live k-tiles takes the place of the
sequential grid dimension: bf16 on mma.sync or fp32 on the CUDA cores, as
:func:`flash_branch` chooses and passes in.  The CUDA tiles are the
kernel's own (up to head dim 256); ``bq``/``bk`` stay in the signature for
the reference's divisibility check, which decides what is accepted.

For CUDA tensors :func:`flash_attention_fwd` launches the kernel; for CPU
tensors it runs :func:`plain_flash_attention_fwd`, the reference's block
loop in torch (its finite ``NEG_INF`` and its floor of ``l`` included).
"""

from __future__ import annotations

import torch

from .._launch import DTYPES, FLOAT, INT, PTR, check_contiguous, check_smem, entry_point, \
    launch, runs_plain, stream_of

NEG_INF = -1e30
# head dims the CUDA kernel takes (the CUDA-core body's accumulator: 64
# columns a thread, 4 threads a query row)
MAX_HEAD_DIM = 256
# the bodies of csrc/flash_fwd.cu, by the index the wrapper passes it
BODIES = ("cores", "mma")


def flash_branch(dtype, hd: int) -> str:
    """The body ``csrc/flash_fwd.cu`` runs, chosen here and passed to it:
    ``"mma"`` (bf16 on mma.sync, over head dims padded to 64, 128 or 256)
    for bf16 with ``hd % 8 == 0``, whose rows are whole 16-byte vectors;
    ``"cores"`` (fp32 on CUDA cores) otherwise."""
    return "mma" if dtype == torch.bfloat16 and hd % 8 == 0 else "cores"


def smem_bytes(hd: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of ``csrc/flash_fwd.cu`` (its
    ``Tc<HD>::SMEM`` and ``launch``): on the tensor cores the 64-row Q tile
    and two stages of K and V of 64 keys (32 at hd 256), bf16 rows padded by
    8, 99 KB at hd 256; on the CUDA cores 64-row Q and 32-key K and V tiles
    (fp32, rows padded by one) and the tile's probabilities, 140 KB at hd
    256."""
    if flash_branch(dtype, hd) == "mma":
        width = 64 if hd <= 64 else 128 if hd <= 128 else 256
        bk = 32 if width == 256 else 64
        return 2 * (64 + 4 * bk) * (width + 8)
    return 4 * ((64 + 2 * 32) * (hd + 1) + 64 * (32 + 1))


def _check(q, k, v, bq: int, bk: int):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B, H, S, hd] and k, v [B, Hkv, S, hd]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, hd) or k.shape[1] == 0 or H % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    bq, bk = min(bq, S), min(bk, S)
    if bq <= 0 or bk <= 0 or S % bq or S % bk:
        raise ValueError(f"S={S} must be a multiple of bq={bq} and bk={bk}")
    return bq, bk


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        bq: int = 128, bk: int = 128):
    """q: [B, H, S, hd]; k, v: [B, Hkv, S, hd] -> (out [B, H, S, hd] in q's
    type, lse [B, H, S] fp32).  CUDA tensors launch ``csrc/flash_fwd.cu``
    (contiguous, hd <= 256); CPU tensors run the plain version."""
    bq, bk = _check(q, k, v, bq, bk)
    if runs_plain(q, k, v):
        return plain_flash_attention_fwd(q, k, v, causal=causal, window=window, bq=bq, bk=bk)
    check_contiguous("flash_fwd", q, k, v)
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd takes head dims up to {MAX_HEAD_DIM}: {q.shape[-1]}")
    body = flash_branch(q.dtype, q.shape[-1])
    if body == "mma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: the tensor-core body copies 16-byte rows; q, k and v "
                         "must start on 16-byte boundaries")
    check_smem("flash_fwd", smem_bytes(q.shape[-1], q.dtype))
    B, H, S, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch_cuda(q, k, v, out, lse, causal=causal, window=window, body=body)
    return out, lse


def _launch_cuda(q, k, v, out, lse, *, causal: bool, window: int, body: str) -> None:
    fn = entry_point("flash_fwd", "flash_fwd_launch",
                     # dtype, body; q, k, v, out, lse; B, H, Hkv, S, hd,
                     # causal, window; scale; stream
                     [INT] * 2 + [PTR] * 5 + [INT] * 7 + [FLOAT, PTR])
    B, H, S, hd = q.shape
    launch("flash_fwd", fn, int(q.dtype == torch.bfloat16), BODIES.index(body), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, k.shape[1], S,
           hd, int(causal), int(window), hd ** -0.5, stream_of(q))


def plain_flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                              bq: int = 128, bk: int = 128):
    """The plain PyTorch version on any device: the reference's online
    softmax over ``bq x bk`` blocks in fp32, dead block pairs skipped."""
    bq, bk = _check(q, k, v, bq, bk)
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    scale = hd ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    dev = q.device
    rows, cols = torch.arange(bq, device=dev)[:, None], torch.arange(bk, device=dev)[None, :]
    outs, lses = [], []
    for q0 in range(0, S, bq):
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, hd), dtype=torch.float32, device=dev)
        qb = qf[:, :, q0:q0 + bq]
        for k0 in range(0, S, bk):
            if causal and k0 > q0 + bq - 1:
                continue
            if window > 0 and q0 - (k0 + bk - 1) >= window:
                continue
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kf[:, :, k0:k0 + bk]) * scale
            qpos, kpos = q0 + rows, k0 + cols
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask &= qpos >= kpos
            if window > 0:
                mask &= qpos - kpos < window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                       vf[:, :, k0:k0 + bk])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)
