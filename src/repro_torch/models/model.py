"""Public model API of the port (the decoders of ``repro/models/model.py``):
the training loss (:func:`loss_fn`, GQA or MLA, dense or MoE), and for GQA
decoders cache init, prefill, the dense decode step and the work-stealing
decode step.  A MoE layer's FFN goes through
:func:`~repro_torch.models.moe.moe_ffn_dispatch`, so ``cfg.moe_dispatch ==
"ws"`` runs the expert megakernel in every step, in prefill and in the
training forward, and its backward megakernel in the training backward
when ``cfg.moe_grad_dispatch == "ws"``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._device import DeviceLike, resolve_device
from . import attention as attn
from . import transformer as tf
from .common import rms_norm, swiglu
from .moe import moe_ffn_dispatch


AUX_LOSS_W = 0.01


def vocab_parallel_xent(hidden, w_un, labels, mask=None, valid_vocab=None,
                        row_weights=None):
    """Cross entropy of ``hidden @ w_un`` (fp32 logits [B, S, V]) against
    ``labels``: the gold logit by an iota == label mask, the log-sum-exp
    around a detached max.  ``valid_vocab`` masks the padded vocab columns;
    ``row_weights`` [B] returns ``Σ_b w_b · token-mean(nll_b)`` instead of
    the global token mean (the reference's multiplicity weighting)."""
    logits = torch.einsum("bsd,dv->bsv", hidden, w_un).float()
    vpos = torch.arange(logits.shape[-1], device=logits.device)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits = torch.where(vpos < valid_vocab, logits, torch.full_like(logits, -1e30))
    gold = torch.where(vpos == labels[..., None], logits, torch.zeros_like(logits)).sum(-1)
    m = logits.amax(dim=-1).detach()
    lse = torch.log(torch.exp(logits - m[..., None]).sum(-1)) + m
    nll = lse - gold
    mk = mask.float() if mask is not None else torch.ones_like(nll)
    if row_weights is not None:
        row_mean = (nll * mk).sum(1) / torch.clamp(mk.sum(1), min=1.0)
        return (row_mean * row_weights).sum()
    return (nll * mk).sum() / torch.clamp(mk.sum(), min=1.0)


def loss_fn(params, cfg, batch, *, remat: bool = True, chunk: int = 1024,
            row_weights=None):
    """Mean next-token cross entropy (+ the MoE aux loss) of ``batch["tokens"]``
    [B, S] (the lm and moe families).  Returns (loss, {"ce", "aux"})."""
    tf.check_supported(cfg, training=True)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, device=tokens.device)
    h, aux = tf.lm_hidden(params, cfg, x, positions, remat=remat, chunk=chunk)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    ce = vocab_parallel_xent(h, _unembed_matrix(params, cfg), labels, mask,
                             valid_vocab=cfg.vocab_size, row_weights=row_weights)
    weight = row_weights.sum() if row_weights is not None else 1.0
    return ce + AUX_LOSS_W * aux * weight, {"ce": ce, "aux": aux}


class Caches(NamedTuple):
    """Stacked per-layer decode state: ``kv`` is a KVCache of [L, B, S, Hkv, hd]."""

    kv: Any = ()


def init_caches(cfg, batch: int, capacity: int, dtype=None,
                device: DeviceLike = None) -> Caches:
    """Zeroed caches with ``capacity`` sequence slots on ``device`` (default cuda)."""
    tf.check_supported(cfg)
    dev = resolve_device(device)
    dt = tf.torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, capacity, cfg.eff_heads[1], cfg.hd)
    return Caches(kv=attn.KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                                  v=torch.zeros(shape, dtype=dt, device=dev)))


def _positions(B: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    """[B, S] int64 positions ``offset .. offset + S - 1`` of every row."""
    return (torch.arange(S, device=device) + offset).expand(B, S)


def _pad_seq(k, cap: int):
    """[B, S, ...] -> [B, cap, ...], the cache slots past S zero."""
    S = k.shape[1]
    if cap == S:
        return k
    out = k.new_zeros((k.shape[0], cap) + tuple(k.shape[2:]))
    out[:, :S] = k
    return out


def _embed(params, cfg, tokens):
    return params["embed"][tokens.long()].to(tf.torch_dtype(cfg.dtype))


def _unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T  # [d, V]
    return params["unembed"]


def _mask_pad_vocab(logits, cfg):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    vpos = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vpos < cfg.vocab_size, logits, torch.full_like(logits, -1e30))


def _layer_cache(kv: attn.KVCache, idx: int) -> attn.KVCache:
    return attn.KVCache(kv.k[idx], kv.v[idx])


def _ffn(h, p, cfg, mode=None, drain=None):
    """The layer's FFN on normalised ``h``: the MoE dispatch where the layer
    has ``moe`` (``mode`` is the expert kernel's; ``drain`` takes its device
    Put), else the SwiGLU MLP."""
    if "moe" in p:
        return moe_ffn_dispatch(h, p["moe"], cfg, mode=mode, drain=drain)[0]
    return swiglu(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", h, _unembed_matrix(params, cfg))[:, 0]
    return _mask_pad_vocab(logits.float(), cfg)


def decode_step(params, cfg, caches: Caches, tokens, pos):
    """One dense decode step. tokens: [B, 1]; pos: scalar or [B] (slot of the
    new token; attends cache[0..pos]).  Returns (logits [B, V] fp32, caches),
    the caches updated in place."""
    h, caches = decode_hidden(params, cfg, caches, tokens, pos)
    return _logits(params, cfg, h), caches


def decode_hidden(params, cfg, caches: Caches, tokens, pos):
    """:func:`decode_step` up to the final norm: returns (the residual stream
    [B, 1, d] in the model's dtype, caches)."""
    tf.check_supported(cfg)
    x = _embed(params, cfg, tokens)
    s = tf._res_scale(cfg)
    h = x
    for idx, w in enumerate(cfg.layer_windows):
        p = tf.layer_params(params, idx)
        hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        a, _ = attn.gqa_decode(hn, p["attn"], cfg, _layer_cache(caches.kv, idx), pos, w)
        h = h + s * a
        hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + s * _ffn(hn, p, cfg)
    return h, caches


def ws_decode_supported(cfg) -> bool:
    """True when :func:`decode_step_ws` covers this architecture: full
    (unwindowed) GQA decoders, dense or MoE."""
    return (
        cfg.family in ("dense", "moe")
        and cfg.attn_kind == "gqa"
        and all(w == 0 for w in cfg.layer_windows)
    )


def decode_step_ws(params, cfg, caches: Caches, tokens, pos, *,
                   schedule: str = "ws", bk: int = 64, n_programs: int = 8,
                   mode=None, drain=None):
    """One decode step with attention on the work-stealing megakernel: one
    launch per layer.  The attention Put is built once per step (the lengths
    are the same in every layer) and placed on the device once; each launch
    clones its mutable arrays.  A MoE layer adds one expert launch with its
    own Put (routing differs per layer); ``mode`` applies to both kernels.

    Host ``pos`` (numpy, ints) builds the Puts on the host and checks each
    launch's drain at once.  A tensor ``pos`` is the reference's traced step:
    every Put is built on the device and nothing is read back to the host;
    the launches' drain checks go to ``drain`` (a
    :class:`~repro_torch.pallas_ws.kernel.DrainCounter`), which the caller
    reads once a step.  Without one, this call makes and reads its own."""
    from repro_torch.pallas_ws.kernel import DrainCounter

    own = drain is None and isinstance(pos, torch.Tensor)
    if own:
        drain = DrainCounter(caches.kv.k.device)
    h, caches = decode_hidden_ws(params, cfg, caches, tokens, pos, schedule=schedule,
                                 bk=bk, n_programs=n_programs, mode=mode, drain=drain)
    logits = _logits(params, cfg, h)
    if own:
        drain.check()
    return logits, caches


def decode_hidden_ws(params, cfg, caches: Caches, tokens, pos, *,
                     schedule: str = "ws", bk: int = 64, n_programs: int = 8,
                     mode=None, drain=None):
    """:func:`decode_step_ws` up to the final norm: returns (the residual
    stream [B, 1, d] in the model's dtype, caches).  A tensor ``pos`` without
    a ``drain`` counter reads its own at the end."""
    from repro_torch.pallas_ws.kernel import DrainCounter
    from repro_torch.pallas_ws.queues import to_device
    from repro_torch.pallas_ws.ragged import decode_queue_state

    if not ws_decode_supported(cfg):
        raise NotImplementedError(f"decode_step_ws does not cover {cfg.name}")
    x = _embed(params, cfg, tokens)
    s = tf._res_scale(cfg)
    B = x.shape[0]
    S = caches.kv.k.shape[2]
    H = params["layers"]["attn"]["wq"].shape[2]
    device_put = isinstance(pos, torch.Tensor)
    own = device_put and drain is None
    if own:
        drain = DrainCounter(x.device)
    # the step's attention Put, once for every layer
    state = decode_queue_state(attn.decode_lengths(pos, B, x.device), H, S,
                               n_programs=n_programs, bk=bk)
    if not device_put:
        state = to_device(state, x.device)
    h = x
    for idx in range(cfg.n_layers):
        p = tf.layer_params(params, idx)
        hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        a, _ = attn.gqa_decode_ws(
            hn, p["attn"], cfg, _layer_cache(caches.kv, idx), pos,
            schedule=schedule, bk=bk, n_programs=n_programs, mode=mode, state=state,
            drain=drain,
        )
        h = h + s * a
        hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + s * _ffn(hn, p, cfg, mode, drain)
    if own:
        drain.check()
    return h, caches


def prefill(params, cfg, batch, *, capacity: int | None = None, chunk: int = 1024):
    """Process a full prompt; returns (last-token logits [B, V] fp32, Caches)."""
    tf.check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, device=dev)
    dt = tf.torch_dtype(cfg.dtype)
    s = tf._res_scale(cfg)
    cap = capacity or S
    caches = init_caches(cfg, B, cap, device=dev)
    h = x
    for idx, w in enumerate(cfg.layer_windows):
        p = tf.layer_params(params, idx)
        hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        k = torch.einsum("bsd,dhe->bshe", hn, p["attn"]["wk"])
        v = torch.einsum("bsd,dhe->bshe", hn, p["attn"]["wv"])
        k = attn.apply_rope(k, positions, cfg.rope_theta)
        a = attn.gqa_train(hn, p["attn"], cfg, positions, window=w, chunk=chunk)
        caches.kv.k[idx, :, :S] = k.to(dt)
        caches.kv.v[idx, :, :S] = v.to(dt)
        h = h + s * a
        hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + s * _ffn(hn, p, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", h[:, -1], _unembed_matrix(params, cfg))
    return _mask_pad_vocab(logits.float(), cfg), caches
