"""Single-token decode attention: wrapper, CUDA launch and plain version
(port of ``repro/kernels/decode_attention/kernel.py``).

The TPU kernel is ``_decode_kernel`` in ``decode_attention``: a grid
``(B, H, nk)`` whose kv-block dimension is sequential, so the online-softmax
state (m, l, acc) carries in VMEM across the sweep, the scalar ``pos`` in
SMEM; blocks past ``pos`` or outside the window are skipped and keys are
masked one by one inside a block.  Here it is ``csrc/decode_attention.cu``:
one CTA per ``(b, h)`` whose loop over the kv blocks of ``bk`` takes the
place of the sequential grid.  ``pos`` reaches it as a one-element int32
tensor on the device, as the reference's SMEM scalar does: no host sync.

For CUDA tensors :func:`decode_attention` launches the kernel; for CPU
tensors it runs :func:`plain_decode_attention`, the same block loop in
torch with the reference's finite ``NEG_INF`` and its floor of ``l``.
"""

from __future__ import annotations

import torch

from .._launch import DTYPES, FLOAT, INT, PTR, check_contiguous, check_smem, entry_point, \
    launch, runs_plain, stream_of

NEG_INF = -1e30
# head dims the CUDA kernel takes (one thread a column of the accumulator)
MAX_HEAD_DIM = 256
THREADS = 256


def smem_bytes(hd: int, bk: int) -> int:
    """Dynamic shared memory of one CTA of ``csrc/decode_attention.cu``: q,
    one block's scores and the threads' partial sums (fp32)."""
    return 4 * (hd + bk + THREADS)


def _check(q, k, v, bk: int) -> int:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B, H, hd] and k, v [B, Hkv, S, hd]: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    if (k.shape[0] != B or k.shape[3] != hd or k.shape[1] == 0 or H % k.shape[1]
            or k.shape[2] == 0):
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    S = k.shape[2]
    bk = min(bk, S)
    if bk <= 0 or S % bk:
        raise ValueError(f"S={S} must be a multiple of bk={bk}")
    return bk


def _pos_tensor(pos, device) -> torch.Tensor:
    """``pos`` as the kernel reads it: a one-element int32 tensor on q's
    device (a device tensor is reshaped in place, never read back)."""
    pos = torch.as_tensor(pos, device=device)
    if pos.numel() != 1 or pos.dtype.is_floating_point or pos.dtype.is_complex:
        raise ValueError(f"pos must be one integer: {tuple(pos.shape)} {pos.dtype}")
    return pos.reshape(1).to(torch.int32).contiguous()


def decode_attention(q, k, v, pos, *, window: int = 0, bk: int = 512):
    """q: [B, H, hd]; k, v: [B, Hkv, S, hd]; pos: int or one-element integer
    tensor -> [B, H, hd] in q's type, attending slots [0, pos] (and within
    ``window`` if > 0).  CUDA tensors launch ``csrc/decode_attention.cu``
    (contiguous, hd <= 256); CPU tensors run the plain version."""
    bk = _check(q, k, v, bk)
    if runs_plain(q, k, v):
        return plain_decode_attention(q, k, v, pos, window=window, bk=bk)
    check_contiguous("decode_attention", q, k, v)
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes head dims up to {MAX_HEAD_DIM}: "
                         f"{q.shape[-1]}")
    check_smem("decode_attention", smem_bytes(q.shape[-1], bk))
    out = torch.empty_like(q)
    _launch_cuda(q, k, v, _pos_tensor(pos, q.device), out, window=window, bk=bk)
    return out


def _launch_cuda(q, k, v, pos, out, *, window: int, bk: int) -> None:
    fn = entry_point("decode_attention", "decode_attention_launch",
                     # dtype; q, k, v, pos, out; B, H, Hkv, S, hd, window, bk;
                     # scale; stream
                     [INT] + [PTR] * 5 + [INT] * 7 + [FLOAT, PTR])
    B, H, hd = q.shape
    launch("decode_attention", fn, int(q.dtype == torch.bfloat16), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, k.shape[1],
           k.shape[2], hd, int(window), bk, hd ** -0.5, stream_of(q))


def plain_decode_attention(q, k, v, pos, *, window: int = 0, bk: int = 512):
    """The plain PyTorch version on any device: the reference's online
    softmax over kv blocks of ``bk`` in fp32.  A block past ``pos`` or
    outside the window leaves the state as it was (``torch.where`` on a
    device-side flag, so ``pos`` is never read back to the host)."""
    bk = _check(q, k, v, bk)
    B, H, hd = q.shape
    S = k.shape[2]
    G = H // k.shape[1]
    qf = q.float()[:, :, None, :]                                  # [B, H, 1, hd]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    pos = torch.as_tensor(pos, device=q.device).reshape(())
    cols = torch.arange(bk, device=q.device)
    m = torch.full((B, H, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, 1, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, bk):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk]) * hd ** -0.5
        kpos = k0 + cols
        valid = kpos <= pos
        if window > 0:
            valid &= pos - kpos < window
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        live = k0 <= pos
        if window > 0:
            live &= pos - (k0 + bk - 1) < window
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = torch.where(live, l * corr + p.sum(dim=-1), l)
        acc = torch.where(live, acc * corr[..., None]
                          + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, k0:k0 + bk]), acc)
        m = torch.where(live, m_new, m)
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None])[:, :, 0].to(q.dtype)
