"""Mixture-of-Experts layer, shared + routed top-k (port of
``repro/models/moe.py``).

* :func:`router_topk` — fp32 router softmax, top-k, renormalised gates and
  the Switch-style load-balancing aux loss; every dispatch shares it.
* :func:`moe_ffn` — the capacity-dropping einsum dispatch, plain torch, as
  the reference leaves it to XLA: tokens over an expert's capacity are
  dropped from the routed path.
* :func:`moe_ffn_dispatch` — picks the dispatch by ``cfg.moe_dispatch``:
  ``"ws"`` is the dropless work-stealing path (``repro_torch.moe_ws``),
  ``"dense"`` the dropping path; ``"mesh-ws"`` is not ported and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, dense_init_slabs


def init_moe(cfg, dtype, *, generator: torch.Generator, device, n_layers=None):
    """Router (fp32), routed experts and shared experts; with ``n_layers``
    every tensor gets a leading [L] axis.  The expert weights are drawn one
    [d, f] slab at a time, so full width needs no fp32 copy of them."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    lead = () if n_layers is None else (n_layers,)
    kw = dict(generator=generator, device=device)
    p = {
        "router": dense_init(d, lead + (d, E), torch.float32, **kw),
        "we_g": dense_init_slabs(d, lead + (E, d, f), dtype, **kw),
        "we_u": dense_init_slabs(d, lead + (E, d, f), dtype, **kw),
        "we_d": dense_init_slabs(f, lead + (E, f, d), dtype, **kw),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["ws_g"] = dense_init(d, lead + (d, fs), dtype, **kw)
        p["ws_u"] = dense_init(d, lead + (d, fs), dtype, **kw)
        p["ws_d"] = dense_init(fs, lead + (fs, d), dtype, **kw)
    return p


def _capacity(group_size: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(cf * group_size * top_k / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def router_topk(xg, p, cfg):
    """xg [G, g, d] -> (probs [G, g, E], normalised top-k gates [G, g, k],
    idx [G, g, k], aux loss).  Equal probabilities are taken lower expert
    index first, as ``jax.lax.top_k`` takes them (``torch.topk`` orders ties
    its own way): a stable descending sort, cut to the first k."""
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :k].contiguous(), idx[..., :k].contiguous()
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss: E * sum_e fraction_tokens_e * mean_prob_e
    onehot_any = F.one_hot(idx, E).float().sum(dim=2)  # [G, g, E]
    frac = onehot_any.mean(dim=1)                       # [G, E]
    aux = E * torch.mean(frac * probs.mean(dim=1))
    return probs, gate_vals, idx, aux


def moe_ffn(x, p, cfg, group_size: int = 1024):
    """x: [B, S, d] -> (y [B, S, d], aux loss): the capacity-dropping
    dispatch.  Each group of ``g`` tokens assigns its (token, choice) pairs
    to per-expert capacity slots in order; pairs past capacity are dropped
    from the routed path (they keep the shared-expert output)."""
    B, S, d = x.shape
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    T = B * S
    g = min(group_size, T)
    G = T // g
    if G * g != T:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    C = _capacity(g, k, E, cf)
    dt = x.dtype
    xg = x.reshape(G, g, d)
    _, gate_vals, idx, aux = router_topk(xg, p, cfg)

    # capacity slots: position of each (token, choice) within its expert queue
    sel = F.one_hot(idx, E)                             # [G, g, k, E] int64
    flat = sel.reshape(G, g * k, E)
    slot = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, k, E)
    in_cap = (slot < C) & (sel > 0)
    # one-hot over C slots; a dropped pair (slot C) is all zero
    slot_oh = F.one_hot(torch.where(in_cap, slot, torch.full_like(slot, C)), C + 1)
    slot_oh = slot_oh[..., :C].to(dt)
    sel_d = sel.to(dt)
    disp = torch.einsum("gtke,gtkec->gtec", sel_d, slot_oh * in_cap[..., None].to(dt))
    comb = torch.einsum("gtke,gtkec->gtec", gate_vals[..., None].to(dt) * sel_d, slot_oh)

    xe = torch.einsum("gtec,gtd->gecd", disp, xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["we_g"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["we_u"])
    ye = torch.einsum("gecf,efd->gecd", h, p["we_d"])
    y = torch.einsum("gecd,gtec->gtd", ye, comb).to(dt)

    if cfg.n_shared_experts:
        hs = F.silu(torch.einsum("gtd,df->gtf", xg, p["ws_g"]))
        hs = hs * torch.einsum("gtd,df->gtf", xg, p["ws_u"])
        y = y + torch.einsum("gtf,fd->gtd", hs, p["ws_d"])
    return y.reshape(B, S, d), aux


def moe_ffn_dispatch(x, p, cfg, group_size: int = 1024, *, mode=None):
    """Route through the dispatch ``cfg.moe_dispatch`` names: ``"ws"`` the
    dropless work-stealing path (``mode`` is its kernel's, free by default),
    ``"dense"`` the capacity-dropping path.  Anything else raises: no
    dispatch substitutes for another unannounced."""
    dispatch = cfg.moe_dispatch
    if dispatch == "ws":
        from repro_torch.moe_ws import moe_ffn_ws

        return moe_ffn_ws(x, p, cfg, group_size, mode=mode,
                          grad_dispatch=cfg.moe_grad_dispatch)
    if dispatch == "mesh-ws":
        raise NotImplementedError("moe_dispatch='mesh-ws' (cross-device expert "
                                  "stealing) is not ported yet")
    if dispatch != "dense":
        raise ValueError(f"unknown moe_dispatch {dispatch!r}")
    return moe_ffn(x, p, cfg, group_size)
