"""Single-token decode attention: wrapper, CUDA launch and plain version
(port of ``repro/kernels/decode_attention/kernel.py``).

The TPU kernel is ``_decode_kernel`` in ``decode_attention``: a grid
``(B, H, nk)`` whose kv-block dimension is sequential, so the online-softmax
state (m, l, acc) carries in VMEM across the sweep, the scalar ``pos`` in
SMEM; blocks past ``pos`` or outside the window are skipped and keys are
masked one by one inside a block.  Here it is ``csrc/decode_attention.cu``,
split-KV flash-decoding: the visible keys are cut into ``n_split`` equal
splits (``n_split`` from :func:`_split`: the shapes and the SM count, never
``pos``; each split's keys computed on the device from ``pos``); one CTA
per (split, kv head, batch row) reads its split's K
and V once for all the kv head's query heads and writes a partial softmax
state (m, l, acc) to fp32 scratch, and a second kernel merges each head's
partials in ascending split order.  ``pos`` reaches both as a one-element
int32 tensor on the device, as the reference's SMEM scalar does: no host
sync.

For CUDA tensors :func:`decode_attention` launches the kernels (one launch
counted); for CPU tensors it runs :func:`plain_decode_attention`, the same
splits, dead-split rule and merge order in torch.
"""

from __future__ import annotations

import torch

from .._launch import DTYPES, FLOAT, INT, PTR, check_contiguous, check_smem, entry_point, \
    launch, runs_plain, stream_of

NEG_INF = -1e30
# head dims the CUDA kernel takes (a lane holds at most 8 columns of a row)
MAX_HEAD_DIM = 256
# csrc/decode_attention.cu's split kernel: threads a CTA, cp.async ring
# depth, rows a lane group takes from a stage, query heads a CTA serves at most
THREADS = 128
STAGES = 2
ROWS = 4
MAX_GROUP = 8
# The split choice: CTAS_PER_SM CTAs an SM where the span allows splits of
# MIN_CHUNK keys or more; never more than bk keys a split.
CTAS_PER_SM = 3
MIN_CHUNK = 128
# SMs of an H100: the plain version on the CPU splits as the kernel on that card
H100_SMS = 132


def _geom(hd: int, esize: int):
    """(nvec, L, tk, rs) of ``csrc/decode_attention.cu``'s ``geom``: a row's
    16-byte vectors, lanes a key, rows a stage, elements a shared-memory row."""
    ve = 16 // esize
    nvec = -(-hd // ve)
    L = 1
    while L < nvec and L < 32:
        L *= 2
    return nvec, L, ROWS * (THREADS // 32) * (32 // L), nvec * ve


def _group(G: int) -> int:
    """Query heads a CTA serves (the kernel's GT): G rounded up to 1, 2, 4
    or 8."""
    return next(gt for gt in (1, 2, 4, MAX_GROUP) if G <= gt or gt == MAX_GROUP)


def smem_bytes(hd: int, dtype=torch.bfloat16, G: int = 1) -> int:
    """Dynamic shared memory of one split CTA of ``csrc/decode_attention.cu``:
    the cp.async ring of K and V stages, or the warps' merge area (fp32 m, l
    and acc of each query head) that reuses it, whichever is larger."""
    esize = dtype.itemsize
    _, _, tk, rs = _geom(hd, esize)
    return max(STAGES * 2 * tk * rs * esize, (THREADS // 32) * _group(G) * (2 + rs) * 4)


def sm_count(device) -> int:
    """SMs of the card ``device`` names; an H100's for any other device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return H100_SMS


def _span(S: int, window: int) -> int:
    """Keys the splits must cover from their base: every visible key lies in
    [base, base + span) for any pos (base = max(0, pos - window + 1))."""
    return min(window, S) if window > 0 else S


def _split(S: int, bk: int, window: int, B: int, Hkv: int, n_sm: int):
    """(chunk, n_split) of the kernel's grid, from the shapes and the SM
    count alone (never ``pos``): ``n_split`` splits a kv head, enough for
    ``CTAS_PER_SM`` CTAs an SM over the B * Hkv kv heads unless that leaves
    fewer than ``MIN_CHUNK`` keys of the span a split, and never more than
    ``bk`` keys a split; ``chunk`` = ceil(span / n_split), the most keys a
    split holds (the device cuts the keys pos leaves visible into n_split
    splits of at most that)."""
    span = _span(S, window)
    n = min(-(-CTAS_PER_SM * n_sm // (B * Hkv)), -(-span // MIN_CHUNK))
    n = max(n, -(-span // bk), 1)
    return -(-span // n), n


def device_cut(pos, S: int, window: int, n_split: int):
    """The device's cut of the visible keys (``place`` in
    ``csrc/decode_attention.cu``), as tensors on ``pos``'s device:
    (first, c, last) with split i holding keys [first[i], min(first[i] + c,
    last + 1)): base = max(0, pos - window + 1) (0 without a window), last =
    min(pos, S - 1), c = ceil((last - base + 1) / n_split) (0 when no key is
    visible), first = base + i * c.  A split is live iff first[i] <= last."""
    pos = torch.as_tensor(pos).reshape(()).long()
    base = (pos - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(pos)
    last = pos.clamp(max=S - 1)
    c = torch.where(last >= base, (last - base + n_split) // n_split, 0)
    return base + torch.arange(n_split, device=pos.device) * c, c, last


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
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention takes head dims up to {MAX_HEAD_DIM}: {hd}")
    check_smem("decode_attention", smem_bytes(hd, q.dtype, H // Hkv))
    _, n_split = _split(S, bk, window, B, Hkv, sm_count(q.device))
    out = torch.empty_like(q)
    part = torch.empty((B, H, n_split, hd + 2), dtype=torch.float32, device=q.device)
    _launch_cuda(q, k, v, _pos_tensor(pos, q.device), out, part, window=window)
    return out


def _launch_cuda(q, k, v, pos, out, part, *, window: int) -> None:
    """One launch of ``decode_attention_launch`` (the split kernel and the
    merge); ``part``'s third dim is the number of splits."""
    fn = entry_point("decode_attention", "decode_attention_launch",
                     # dtype; q, k, v, pos, out, part; B, H, Hkv, S, hd, window,
                     # n_split; scale; stream
                     [INT] + [PTR] * 6 + [INT] * 7 + [FLOAT, PTR])
    B, H, hd = q.shape
    launch("decode_attention", fn, int(q.dtype == torch.bfloat16), q.data_ptr(),
           k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(), part.data_ptr(), B, H,
           k.shape[1], k.shape[2], hd, int(window), part.shape[2], hd ** -0.5, stream_of(q))


def plain_decode_attention(q, k, v, pos, *, window: int = 0, bk: int = 512,
                           split: int | None = None):
    """The plain PyTorch version on any device, split and merged as the
    kernel does: the visible keys cut into n_split splits by
    :func:`device_cut`, n_split = ceil(span / ``split``) (by default
    :func:`_split`'s for the shape), each split's softmax state (m, l, acc)
    in fp32, a split with no visible key dead, and the live ones merged in
    ascending split order.  ``pos`` stays on q's device (the splits are
    device tensors, never read back)."""
    bk = _check(q, k, v, bk)
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    span = _span(S, window)
    if split is None:
        _, n_split = _split(S, bk, window, B, Hkv, sm_count(q.device))
    else:
        if int(split) <= 0:
            raise ValueError(f"split must be a positive number of keys: {split}")
        n_split = -(-span // int(split))
    cmax = -(-span // n_split)
    dev = q.device
    first, c, last = device_cut(torch.as_tensor(pos, device=dev), S, window, n_split)
    j = torch.arange(cmax, device=dev)
    idx = first[:, None] + j                             # [n_split, cmax]
    valid = (j < c) & (idx <= last)
    rows = idx.clamp(0, S - 1).flatten()
    kf, vf = (t.index_select(2, rows).float().view(B, Hkv, n_split, cmax, hd) for t in (k, v))
    s = torch.einsum("bkgd,bkncd->bkgnc", q.float().view(B, Hkv, G, hd), kf) * hd ** -0.5
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                   # [B, Hkv, G, n_split]
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnc,bkncd->bkgnd", p, vf)
    live = valid.any(dim=-1)                             # [n_split]
    M = torch.where(live, m, NEG_INF).amax(dim=-1)
    num = torch.zeros((B, Hkv, G, hd), dtype=torch.float32, device=dev)
    den = torch.zeros((B, Hkv, G), dtype=torch.float32, device=dev)
    for i in range(n_split):                             # the merge's order
        w = torch.where(live[i], torch.exp(m[..., i] - M), 0.0)
        num = num + w[..., None] * acc[..., i, :]
        den = den + w * l[..., i]
    out = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)
