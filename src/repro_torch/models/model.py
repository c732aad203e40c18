"""Public model API of the port (``repro/models/model.py``): the training
loss (:func:`loss_fn`), cache init, prefill and the dense decode step for
every family the port builds (GQA or MLA decoders, dense or MoE; the vlm
backbone with its patch prefix; the encdec model with its encoder and
cross-attention caches; the ssm and hybrid stacks), and the work-stealing
decode step for the GQA decoders (dense, MoE and vlm).  MLA, encdec and the
ssm and hybrid stacks decode on the dense step, as in the reference
(:func:`ws_decode_supported` is false for them).  A MoE layer's FFN goes
through :func:`~repro_torch.models.moe.moe_ffn_dispatch`, so
``cfg.moe_dispatch == "ws"`` runs the expert megakernel in every step, in
prefill and in the training forward, and its backward megakernel in the
training backward when ``cfg.moe_grad_dispatch == "ws"``.

Batch dicts by family (as the reference's): ``{"tokens": [B, S]}``; vlm
adds ``"patches"`` [B, n_patches, d] (they go before the text, whose
positions start at ``n_patches``: decode a vlm row at ``n_patches`` plus
its text position); encdec adds ``"frames"`` [B, enc_S, d] for the
encoder.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .._device import DeviceLike, resolve_device
from . import attention as attn
from . import fsdp
from . import transformer as tf
from .common import rms_norm, swiglu
from .moe import moe_ffn_dispatch
from .ssm import SSMCache, init_ssm_cache, mamba_decode, mamba_train


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
    # under a data mesh the token count is the global batch's (fsdp.dp_sum),
    # so the ranks' shares sum to the global mean
    return (nll * mk).sum() / torch.clamp(fsdp.dp_sum(mk.sum()), min=1.0)


def loss_fn(params, cfg, batch, *, remat: bool = True, chunk: int = 1024,
            row_weights=None):
    """Mean next-token cross entropy (+ the MoE aux loss) of ``batch["tokens"]``
    [B, S]; a vlm model's over the text positions only, after the patches.
    Returns (loss, {"ce", "aux"}).

    Under a mesh with data axes (``sharding.use_mesh``) ``batch`` is this
    rank's slice of the global batch and the loss and both metrics are this
    rank's shares: summed over the data-parallel ranks they are the global
    batch's (the token mean over the global count, the aux loss the mean of
    every global routing group's).  ZeRO-sharded parameters are gathered
    where they are read; a tied embedding once, for both of its uses."""
    tf.check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    if cfg.tie_embeddings and fsdp.layout_of(params["embed"]) is not None:
        params = {**params, "embed": fsdp.gathered(params["embed"])}
    x = _embed(params, cfg, tokens)
    if cfg.family == "encdec":
        enc_out = tf.encode(params, cfg, batch["frames"], remat=remat, chunk=chunk)
        h = tf.decoder_hidden(params, cfg, x, _positions(B, S, device=dev), enc_out,
                              remat=remat, chunk=chunk)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    elif cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        h, aux = tf.lm_hidden(params, cfg, x, _positions(B, x.shape[1], device=dev),
                              remat=remat, chunk=chunk)
        h = h[:, x.shape[1] - S:]  # text positions only
    else:
        h, aux = tf.lm_hidden(params, cfg, x, _positions(B, S, device=dev), remat=remat,
                              chunk=chunk)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=dev)
    mask[:, -1] = 0.0
    ce = vocab_parallel_xent(h, _unembed_matrix(params, cfg), labels, mask,
                             valid_vocab=cfg.vocab_size, row_weights=row_weights)
    # every rank holds as many whole routing groups (fsdp.moe_group)
    aux = aux / fsdp.dp_size()
    weight = fsdp.dp_sum(row_weights.sum()) if row_weights is not None else 1.0
    return ce + AUX_LOSS_W * aux * weight, {"ce": ce, "aux": aux}


class Caches(NamedTuple):
    """Stacked per-layer decode state, the batch on axis 1 of every tensor.
    Unused fields are ()."""

    kv: Any = ()         # attention decoders: KVCache or MLACache of [L, B, S, ...]
    ssm: Any = ()        # ssm / hybrid: SSMCache of [L, B, ...]
    shared_kv: Any = ()  # hybrid: KVCache of [n_apps, B, S, Hkv, hd]
    cross_kv: Any = ()   # encdec: KVCache of [L, B, enc_S, Hkv, hd]


def cache_tensors(caches: Caches):
    """Every tensor of ``caches`` in field order (the splice's walk)."""
    return [t for field in caches for t in field]


def _kv_zeros(n: int, batch: int, capacity: int, cfg, dt, dev) -> attn.KVCache:
    shape = (n, batch, capacity, cfg.eff_heads[1], cfg.hd)
    return attn.KVCache(k=torch.zeros(shape, dtype=dt, device=dev),
                        v=torch.zeros(shape, dtype=dt, device=dev))


def init_caches(cfg, batch: int, capacity: int, dtype=None,
                device: DeviceLike = None, cross_len: int | None = None) -> Caches:
    """Zeroed caches with ``capacity`` sequence slots on ``device`` (default
    cuda).  The hybrid's shared-attention cache has one entry per application
    of a shared block (``n_apps = L // hybrid_attn_every``), not per layer;
    an MLA model's holds the kv latent and the roped key; an encdec model's
    adds the cross-attention k/v of ``cross_len`` encoder positions (default
    ``enc_seq_len``)."""
    tf.check_supported(cfg)
    dev = resolve_device(device)
    dt = tf.torch_dtype(dtype or cfg.dtype)
    L = cfg.n_layers
    if cfg.is_ssm:
        ssm = init_ssm_cache(batch, cfg, dt, device=dev, n_layers=L)
        every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        shared = _kv_zeros(L // every, batch, capacity, cfg, dt, dev) if every else ()
        return Caches(ssm=ssm, shared_kv=shared)
    if cfg.attn_kind == "mla":
        return Caches(kv=attn.MLACache(
            ckv=torch.zeros((L, batch, capacity, cfg.kv_lora_rank), dtype=dt, device=dev),
            kr=torch.zeros((L, batch, capacity, cfg.rope_head_dim), dtype=dt, device=dev)))
    if cfg.family == "encdec":
        Ld = cfg.n_dec_layers
        return Caches(kv=_kv_zeros(Ld, batch, capacity, cfg, dt, dev),
                      cross_kv=_kv_zeros(Ld, batch, cross_len or cfg.enc_seq_len, cfg, dt,
                                         dev))
    return Caches(kv=_kv_zeros(L, batch, capacity, cfg, dt, dev))


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
    return fsdp.gathered(params["embed"])[tokens.long()].to(tf.torch_dtype(cfg.dtype))


def _unembed_matrix(params, cfg):
    if cfg.tie_embeddings:
        return fsdp.gathered(params["embed"]).T  # [d, V]
    return fsdp.gathered(params["unembed"])


def _mask_pad_vocab(logits, cfg):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    vpos = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vpos < cfg.vocab_size, logits, torch.full_like(logits, -1e30))


def _layer_cache(kv, idx: int):
    """Layer ``idx``'s views of a stacked KVCache or MLACache."""
    return type(kv)(*(t[idx] for t in kv))


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
    if cfg.is_ssm:
        return _decode_hidden_ssm(params, cfg, caches, x, pos), caches
    if cfg.family == "encdec":
        return _decode_hidden_encdec(params, cfg, caches, x, pos), caches
    s = tf._res_scale(cfg)
    h = x
    for idx, w in enumerate(cfg.layer_windows):
        p = tf.layer_params(params, idx)
        hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        cache = _layer_cache(caches.kv, idx)
        if cfg.attn_kind == "mla":
            a, _ = attn.mla_decode(hn, p["attn"], cfg, cache, pos)
        else:
            a, _ = attn.gqa_decode(hn, p["attn"], cfg, cache, pos, w)
        h = h + s * a
        hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + s * _ffn(hn, p, cfg)
    return h, caches


def _decode_hidden_encdec(params, cfg, caches: Caches, h, pos):
    """The encdec decoder's step: each layer's causal self-attention over its
    kv cache at ``pos``, its cross-attention over the prefill's encoder k/v
    (``cross_kv``, read only), its MLP."""
    for idx in range(cfg.n_dec_layers):
        p = tf.layer_params(params, idx)
        hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        a, _ = attn.gqa_decode(hn, p["attn"], cfg, _layer_cache(caches.kv, idx), pos, 0)
        h = h + a
        hn = rms_norm(h, p["cross_norm"], cfg.norm_eps)
        h = h + tf._cross_attn(hn, p["cross"], cfg, _layer_cache(caches.cross_kv, idx))
        hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
    return h


def _decode_hidden_ssm(params, cfg, caches: Caches, h, pos):
    """The ssm / hybrid decode: each layer's :func:`mamba_decode` (its state
    and conv caches written back in place), and in the hybrid one of the two
    shared attention + MLP blocks after every ``hybrid_attn_every``-th
    layer, over its application's cache at ``pos``."""
    every = cfg.hybrid_attn_every
    for idx in range(cfg.n_layers):
        p = tf.layer_params(params, idx)
        one = SSMCache(*(t[idx] for t in caches.ssm))
        out, new = mamba_decode(rms_norm(h, p["norm"], cfg.norm_eps), p["mamba"], cfg, one)
        h = h + out
        for dst, src in zip(one, new):
            dst.copy_(src)
        if tf.shared_attn_after(cfg, idx):
            sp = tf.shared_block_params(params, idx, every)
            app = idx // every
            hn = rms_norm(h, sp["attn_norm"], cfg.norm_eps)
            a, _ = attn.gqa_decode(hn, sp["attn"], cfg, _layer_cache(caches.shared_kv, app),
                                   pos, 0)
            h = h + a
            hn = rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
            h = h + swiglu(hn, sp["mlp"]["wg"], sp["mlp"]["wu"], sp["mlp"]["wd"])
    return h


def ws_decode_supported(cfg) -> bool:
    """True when :func:`decode_step_ws` covers this architecture: full
    (unwindowed) GQA decoders, dense, MoE or the vlm backbone (the
    reference's predicate).  MLA, encdec, ssm and hybrid keep the dense step."""
    return (
        cfg.family not in ("ssm", "hybrid", "encdec")
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

    if not ws_decode_supported(cfg):
        raise NotImplementedError(f"decode_step_ws does not cover {cfg.name}")
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
    """Process a full prompt; returns (last-token logits [B, V] fp32, Caches).
    A vlm prompt is its patches then its tokens (``capacity`` counts both);
    an encdec prompt's frames fill the cross-attention caches."""
    tf.check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(params, cfg, tokens)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        S = x.shape[1]
    positions = _positions(B, S, device=dev)
    cap = capacity or S
    frames = batch["frames"] if cfg.family == "encdec" else None
    caches = init_caches(cfg, B, cap, device=dev,
                         cross_len=None if frames is None else frames.shape[1])
    if frames is not None:
        h = _prefill_encdec(params, cfg, caches, frames, x, positions, chunk)
    elif cfg.is_ssm:
        h = _prefill_ssm(params, cfg, caches, x, positions, chunk)
    else:
        h = _prefill_attn(params, cfg, caches, x, positions, chunk)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", h[:, -1], _unembed_matrix(params, cfg))
    return _mask_pad_vocab(logits.float(), cfg), caches


def _prompt_kv(hn, p, cfg, positions):
    """The prompt's roped k and its v [B, S, Hkv, hd] for the cache."""
    k = torch.einsum("bsd,dhe->bshe", hn, p["attn"]["wk"])
    v = torch.einsum("bsd,dhe->bshe", hn, p["attn"]["wv"])
    return attn.apply_rope(k, positions, cfg.rope_theta), v


def _prefill_ssm(params, cfg, caches: Caches, h, positions, chunk):
    """The ssm / hybrid prefill into ``caches``: every layer's decode-resume
    cache (the final SSD state and the conv's last inputs) and the shared
    blocks' prompt k/v, by application."""
    S = h.shape[1]
    every = cfg.hybrid_attn_every
    for idx in range(cfg.n_layers):
        p = tf.layer_params(params, idx)
        out, c = mamba_train(rms_norm(h, p["norm"], cfg.norm_eps), p["mamba"], cfg,
                             return_cache=True)
        h = h + out
        for dst, src in zip(caches.ssm, c):
            dst[idx] = src
        if tf.shared_attn_after(cfg, idx):
            sp = tf.shared_block_params(params, idx, every)
            app = idx // every
            hn = rms_norm(h, sp["attn_norm"], cfg.norm_eps)
            k, v = _prompt_kv(hn, sp, cfg, positions)
            h = h + attn.gqa_train(hn, sp["attn"], cfg, positions, window=0, chunk=chunk)
            hn = rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
            h = h + swiglu(hn, sp["mlp"]["wg"], sp["mlp"]["wu"], sp["mlp"]["wd"])
            caches.shared_kv.k[app, :, :S] = k
            caches.shared_kv.v[app, :, :S] = v
    return h


def _prefill_attn(params, cfg, caches: Caches, x, positions, chunk):
    """The attention decoders' prefill into ``caches``: each layer's prompt
    k/v, or for MLA its kv latent and roped key."""
    S = x.shape[1]
    s = tf._res_scale(cfg)
    h = x
    for idx, w in enumerate(cfg.layer_windows):
        p = tf.layer_params(params, idx)
        hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
        if cfg.attn_kind == "mla":
            caches.kv.ckv[idx, :, :S] = torch.einsum("bsd,dr->bsr", hn, p["attn"]["wdkv"])
            kr = torch.einsum("bsd,de->bse", hn, p["attn"]["wkr"])[:, :, None, :]
            caches.kv.kr[idx, :, :S] = attn.apply_rope(kr, positions, cfg.rope_theta)[:, :, 0]
            a = attn.mla_train(hn, p["attn"], cfg, positions, window=w, chunk=chunk)
        else:
            k, v = _prompt_kv(hn, p, cfg, positions)
            caches.kv.k[idx, :, :S] = k
            caches.kv.v[idx, :, :S] = v
            a = attn.gqa_train(hn, p["attn"], cfg, positions, window=w, chunk=chunk)
        h = h + s * a
        hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
        h = h + s * _ffn(hn, p, cfg)
    return h


def _prefill_encdec(params, cfg, caches: Caches, frames, x, positions, chunk):
    """The encdec prefill into ``caches``: the encoder over ``frames``, then
    the decoder over the prompt, each layer's prompt k/v into the kv cache
    and its encoder k/v into the cross cache (of the frames' length, as the
    reference's)."""
    S = positions.shape[1]
    enc_out = tf.encode(params, cfg, frames, remat=False, chunk=chunk)
    h = x
    for idx in range(cfg.n_dec_layers):
        p = tf.layer_params(params, idx)
        k, v = _prompt_kv(rms_norm(h, p["attn_norm"], cfg.norm_eps), p, cfg, positions)
        caches.kv.k[idx, :, :S] = k
        caches.kv.v[idx, :, :S] = v
        ck, cv = tf.cross_kv(p["cross"], enc_out)
        caches.cross_kv.k[idx] = ck
        caches.cross_kv.v[idx] = cv
        h = tf.decoder_layer(h, p, cfg, positions, (ck, cv), chunk)
    return h
