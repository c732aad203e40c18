"""GQA and MLA attention (port of ``repro/models/attention.py``: GQA
prefill and decode, MLA training, prefill and decode).

* train / prefill — chunked flash-style attention as plain tensor ops
  (:func:`flash_ref`): outer loop over query chunks, inner loop over key
  chunks with an online softmax.  Its backward is the reference's custom
  VJP as a ``torch.autograd.Function``: P is recomputed blockwise from the
  saved logsumexp, so training keeps no score blocks.  A causal window
  shorter than the sequence takes the banded path (:func:`_flash_banded`):
  each query chunk meets only the key chunks it can see.  The reference
  computes it outside any Pallas kernel, and so does the port.
* MLA (deepseek-v2) training and prefill — :func:`mla_train`: low-rank q
  and kv projections, a rope part shared across heads, then
  :func:`flash_ref`.  MLA decode — :func:`mla_decode`, the reference's
  absorbed form: the cache (:class:`MLACache`) holds the kv latent and the
  roped key, W_uk folds into the query and W_uv into the output, so no
  per-head key or value is built.
* decode — one query token against a [B, S, Hkv, hd] KV cache:
  :func:`gqa_decode` is the dense masked contraction (the oracle);
  :func:`gqa_decode_ws` routes the attention core through the work-stealing
  megakernel over the live per-slot lengths.

The port updates KV caches in place (the reference returns new arrays):
one cache per replica is all the memory full width can spare.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .common import apply_rope, dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S, Hkv, hd]   (stacked caches: [L, B, S, Hkv, hd])
    v: torch.Tensor


# ---------------------------------------------------------------------------
# chunked flash attention (train / prefill)


def _pick_chunk(S: int, chunk: int) -> int:
    """Largest divisor of S that is <= chunk."""
    c = min(chunk, S)
    while S % c != 0:
        c -= 1
    return c


def _flash_mask(s, qpos, kpos, causal: bool, win: int):
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if win > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < win
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _flash_fwd_impl(q, k, v, win: int, qoff: int, causal: bool, chunk: int):
    """Online-softmax attention; q, k, v: [B, S, H, hd] (kv head-expanded).
    Returns (out [B, Sq, H, hdv] in q's dtype, lse [B, Sq, H] fp32)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    hdv = v.shape[-1]
    c = _pick_chunk(Sq, chunk)
    ck = _pick_chunk(Sk, chunk)
    nq, nk = Sq // c, Sk // ck
    scale = hd ** -0.5
    qs = q.reshape(B, nq, c, H, hd).permute(1, 0, 3, 2, 4)  # [nq, B, H, c, hd]
    ks = k.reshape(B, nk, ck, H, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(B, nk, ck, H, hdv).permute(1, 0, 3, 2, 4)
    pos = torch.arange(c, device=q.device)
    posk = torch.arange(ck, device=q.device)
    outs, lses = [], []
    for qi in range(nq):
        qb = qs[qi]
        qpos = qoff + qi * c + pos
        m = torch.full((B, H, c), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, c), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, c, hdv), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            kb, vb = ks[ki], vs[ki]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb).float() * scale
            s = _flash_mask(s, qpos, ki * ck + posk, causal, win)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vb.dtype), vb).float()
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, Sq, H, hdv)
    lse = torch.stack(lses).permute(1, 0, 3, 2).reshape(B, Sq, H)  # [nq,B,H,c] -> [B,Sq,H]
    return out, lse


def _flash_bwd_impl(q, k, v, out, lse, do, win: int, qoff: int, causal: bool, chunk: int):
    """Flash backward: P recomputed per (q-chunk, k-chunk) block from the
    saved lse; transients are O(chunk²), dq/dk/dv accumulate in fp32."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    hdv = v.shape[-1]
    scale = hd ** -0.5
    c = _pick_chunk(Sq, chunk)
    ck = _pick_chunk(Sk, chunk)
    nq, nk = Sq // c, Sk // ck
    D = (do.float() * out.float()).sum(-1)                  # [B, Sq, H]
    qf, dof = q.float(), do.float()
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, H, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Sk, H, hdv), dtype=torch.float32, device=q.device)
    qpos_base = torch.arange(c, device=q.device)
    kpos_base = torch.arange(ck, device=q.device)
    for qi in range(nq):
        qsl = slice(qi * c, (qi + 1) * c)
        qb, dob = qf[:, qsl], dof[:, qsl]                   # [B, c, H, hd]
        lseb = lse[:, qsl].transpose(1, 2)[..., None]       # [B, H, c, 1]
        Db = D[:, qsl].transpose(1, 2)[..., None]
        qpos = qoff + qi * c + qpos_base
        for ki in range(nk):
            ksl = slice(ki * ck, (ki + 1) * ck)
            kb, vb = kf[:, ksl], vf[:, ksl]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            s = _flash_mask(s, qpos, ki * ck + kpos_base, causal, win)
            p = torch.exp(s - lseb)                         # [B, H, c, ck]
            dv[:, ksl] += torch.einsum("bhqk,bqhd->bkhd", p, dob)
            dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
            ds = p * (dp - Db) * scale
            dq[:, qsl] += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
            dk[:, ksl] += torch.einsum("bhqk,bqhd->bkhd", ds, qb)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """:func:`flash_ref` with the reference's custom VJP: the forward saves
    (q, k, v, out, lse) and the backward recomputes P blockwise."""

    @staticmethod
    def forward(ctx, q, k, v, win, qoff, causal, chunk):
        out, lse = _flash_fwd_impl(q, k, v, win, qoff, causal, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (win, qoff, causal, chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_ref(q, k, v, *, causal: bool, window: int, chunk: int = 1024):
    """Online-softmax attention over [B, S, H, hd] (kv head-expanded);
    window <= 0 is full, window > 0 masks keys ``window`` or more positions
    behind the query.  Differentiable through the flash VJP.

    A window > 0 with ``causal`` and Sq == Sk > window takes the banded path
    (:func:`_flash_banded`, the reference's condition): each query chunk
    contracts only the key chunks it can see, so the work scales with
    S * window instead of S^2.  Every other call masks every block."""
    window = int(window)
    if window > 0 and causal and q.shape[1] == k.shape[1] > window:
        return _flash_banded(q, k, v, window, chunk)
    return _Flash.apply(q, k, v, window, 0, causal, chunk)


def _flash_banded(q, k, v, window: int, chunk: int):
    """Causal sliding-window attention over a band of key chunks: query
    chunk ``qi`` (of ``c`` rows) attends key chunks ``[lo, lo + nb)`` with
    ``nb = ceil(window / c) + 1`` and ``lo = max(qi - (nb - 1), 0)``, through
    the same flash core (and VJP) with the chunk's offset ``(qi - lo) * c``
    in the band, so the mask stays exact.  The band is a view of k and v."""
    S = q.shape[1]
    c = _pick_chunk(S, min(chunk, max(window, 16)))
    nq = S // c
    nb = min(-(-window // c) + 1, nq)  # key chunks visible to one query chunk
    outs = []
    for qi in range(nq):
        lo = max(qi - (nb - 1), 0)
        band = slice(lo * c, (lo + nb) * c)
        outs.append(_Flash.apply(q[:, qi * c:(qi + 1) * c], k[:, band], v[:, band],
                                 window, (qi - lo) * c, True, c))
    return torch.cat(outs, dim=1)


def expand_kv(k, n_rep: int):
    """[B, S, Hkv, hd] -> [B, S, Hkv*n_rep, hd] (GQA head expansion)."""
    if n_rep == 1:
        return k
    B, S, Hkv, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, Hkv, n_rep, hd).reshape(B, S, Hkv * n_rep, hd)


def gqa_train(x, p, cfg, positions, window, chunk: int = 1024, causal: bool = True):
    """Causal (optionally windowed) self-attention over [B, S, d]; with
    ``causal=False`` (the encdec encoder) every position sees every other."""
    H, Hkv = p["wq"].shape[1], p["wk"].shape[1]
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k = expand_kv(k, H // Hkv)
    v = expand_kv(v, H // Hkv)
    o = flash_ref(q, k, v, causal=causal, window=window, chunk=chunk)
    return torch.einsum("bshe,hed->bsd", o, p["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# decode


def broadcast_pos(pos, B: int, device) -> torch.Tensor:
    """Scalar or [B] ints -> [B] int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(pos) if not isinstance(pos, torch.Tensor) else pos,
                           dtype=torch.int64).to(device).reshape(-1).expand(B)


def host_lengths(pos, B: int) -> np.ndarray:
    """Per-slot live lengths ``pos + 1`` on the host (the ragged decode shape)."""
    p = pos.cpu().numpy() if isinstance(pos, torch.Tensor) else np.asarray(pos)
    return np.broadcast_to(p.reshape(-1), (B,)).astype(np.int64) + 1


def _update_at(cache, new, pos_b):
    """cache: [B, S, ...]; new: [B, 1, ...]; per-row write at pos_b, in place
    (the start index clamps to S - 1 like ``dynamic_update_slice``)."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos_b.clamp(0, S - 1)] = new[:, 0].to(cache.dtype)
    return cache


def _decode_qkv(x, p, cfg, cache: KVCache, pos_b):
    """Project q/k/v for the new token, rope at the per-slot positions, and
    splice k/v into the cache.  Returns (q [B, 1, H, hd], KVCache)."""
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k_new = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v_new = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    q = apply_rope(q, pos_b[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos_b[:, None], cfg.rope_theta)
    kc = _update_at(cache.k, k_new, pos_b)
    vc = _update_at(cache.v, v_new, pos_b)
    return q, KVCache(kc, vc)


def gqa_decode(x, p, cfg, cache: KVCache, pos, window):
    """One-token dense decode: x [B, 1, d]; attends cache slots [0, pos_b]."""
    B = x.shape[0]
    hd = cfg.hd
    H, Hkv = p["wq"].shape[1], p["wk"].shape[1]
    G = H // Hkv
    S = cache.k.shape[1]
    pos_b = broadcast_pos(pos, B, x.device)
    q, new_cache = _decode_qkv(x, p, cfg, cache, pos_b)
    kc, vc = new_cache.k, new_cache.v
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bkgd,bskd->bskg", qg, kc).float() * hd ** -0.5
    kpos = torch.arange(S, device=x.device)
    valid = kpos[None, :] <= pos_b[:, None]
    if window > 0:
        valid &= (pos_b[:, None] - kpos[None, :]) < window
    s = torch.where(valid[:, :, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=1)
    o = torch.einsum("bskg,bske->bkge", w.to(vc.dtype), vc)
    o = o.reshape(B, 1, H, hd)
    return torch.einsum("bshe,hed->bsd", o, p["wo"]), new_cache


def decode_lengths(pos, B: int, device):
    """The live lengths ``pos + 1`` of a decode step: on the host for host
    ``pos`` (the host Put), on ``device`` for a tensor ``pos`` (the device
    Put, nothing read back)."""
    if isinstance(pos, torch.Tensor):
        return broadcast_pos(pos, B, device) + 1
    return host_lengths(pos, B)


def gqa_decode_ws(x, p, cfg, cache: KVCache, pos, *, schedule="ws", bk=64,
                  n_programs=8, mode=None, state=None, drain=None):
    """One-token decode with the attention core on the work-stealing
    megakernel over the live lengths ``pos_b + 1``.  The kernel reads the
    [B, S, Hkv, hd] cache through a transposed view: no copy, no padding.
    ``state`` may carry the step's Put, built once for all layers.  A tensor
    ``pos`` takes the device Put, its unexecuted tasks counted in ``drain``
    (:func:`~repro_torch.pallas_ws.ragged.ragged_decode_attention`)."""
    from repro_torch.pallas_ws.ragged import ragged_decode_attention

    B = x.shape[0]
    hd = cfg.hd
    H = p["wq"].shape[1]
    pos_b = broadcast_pos(pos, B, x.device)
    q, new_cache = _decode_qkv(x, p, cfg, cache, pos_b)
    o = ragged_decode_attention(
        q.reshape(B, H, hd),
        new_cache.k.permute(0, 2, 1, 3),  # [B, S, Hkv, hd] -> [B, Hkv, S, hd] view
        new_cache.v.permute(0, 2, 1, 3),
        decode_lengths(pos, B, x.device),
        schedule=schedule, n_programs=n_programs, bk=bk, mode=mode, state=state,
        drain=drain,
    )
    o = o.reshape(B, 1, H, hd).to(x.dtype)
    return torch.einsum("bshe,hed->bsd", o, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2), training


def init_mla(cfg, dtype, *, generator, device, n_layers=None):
    """MLA projections; with ``n_layers`` every tensor gets a leading [L]
    axis (the reference's layout)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    qlr, kvlr, rhd, vhd = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_hd
    lead = () if n_layers is None else (n_layers,)

    def init(d_in, shape):
        return dense_init(d_in, lead + shape, dtype, generator=generator, device=device)

    p = {
        "wdkv": init(d, (d, kvlr)),
        "wkr": init(d, (d, rhd)),
        "wuk": init(kvlr, (kvlr, H, hd)),
        "wuv": init(kvlr, (kvlr, H, vhd)),
        "wo": init(H * vhd, (H, vhd, d)),
    }
    if qlr:
        p["wdq"] = init(d, (d, qlr))
        p["wuq"] = init(qlr, (qlr, H, hd + rhd))
    else:
        p["wq"] = init(d, (d, H, hd + rhd))
    return p


def _mla_q(x, p, cfg, positions):
    hd = cfg.hd
    if cfg.q_lora_rank:
        cq = torch.einsum("bsd,dr->bsr", x, p["wdq"])
        q = torch.einsum("bsr,rhe->bshe", cq, p["wuq"])
    else:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_train(x, p, cfg, positions, window: int, chunk: int = 1024):
    """Causal MLA self-attention over [B, S, d]: q and kv through their
    low-rank latents, the rope key shared across heads."""
    B, S, _ = x.shape
    H, rhd = cfg.n_heads, cfg.rope_head_dim
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    ckv = torch.einsum("bsd,dr->bsr", x, p["wdkv"])
    k_rope = apply_rope(torch.einsum("bsd,de->bse", x, p["wkr"])[:, :, None, :], positions,
                        cfg.rope_theta)  # [B, S, 1, rhd]
    k_nope = torch.einsum("bsr,rhe->bshe", ckv, p["wuk"])
    v = torch.einsum("bsr,rhe->bshe", ckv, p["wuv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rhd)], dim=-1)
    o = flash_ref(q, k, v, causal=True, window=window, chunk=chunk)
    return torch.einsum("bshe,hed->bsd", o, p["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2), decode


class MLACache(NamedTuple):
    ckv: torch.Tensor  # [B, S, kv_lora]   (stacked caches: [L, B, S, kv_lora])
    kr: torch.Tensor   # [B, S, rhd]


def mla_decode(x, p, cfg, cache: MLACache, pos):
    """Absorbed one-token MLA decode: x [B, 1, d] attends cache slots
    [0, pos_b] with the scores and the output in the latent space
    (``q_abs = q_nope · W_uk`` against ``ckv``, plus the rope term against
    ``kr``; the latent output through ``W_uv``).  The new token's ``ckv`` and
    roped ``kr`` are written at ``pos_b``, in place.  The casts follow the
    reference: scores in the cache's dtype, then fp32, scale
    ``(hd + rhd)^-0.5``, softmax weights back in the cache's dtype."""
    B = x.shape[0]
    hd, rhd = cfg.hd, cfg.rope_head_dim
    S = cache.ckv.shape[1]
    pos_b = broadcast_pos(pos, B, x.device)
    q_nope, q_rope = _mla_q(x, p, cfg, pos_b[:, None])  # [B, 1, H, hd / rhd]
    ckv_new = torch.einsum("bsd,dr->bsr", x, p["wdkv"])
    kr_new = apply_rope(torch.einsum("bsd,de->bse", x, p["wkr"])[:, :, None, :],
                        pos_b[:, None], cfg.rope_theta)[:, :, 0, :]
    ckv = _update_at(cache.ckv, ckv_new, pos_b)
    kr = _update_at(cache.kr, kr_new, pos_b)
    q_abs = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], p["wuk"])  # W_uk absorbed
    s = torch.einsum("bhr,bsr->bsh", q_abs, ckv)
    s = s + torch.einsum("bhe,bse->bsh", q_rope[:, 0], kr)
    s = s.float() * (hd + rhd) ** -0.5
    kpos = torch.arange(S, device=x.device)
    valid = (kpos[None, :] <= pos_b[:, None])[:, :, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=1)
    o_lat = torch.einsum("bsh,bsr->bhr", w.to(ckv.dtype), ckv)
    o = torch.einsum("bhr,rhe->bhe", o_lat, p["wuv"])[:, None]  # [B, 1, H, vhd]
    return torch.einsum("bshe,hed->bsd", o, p["wo"]), MLACache(ckv, kr)
