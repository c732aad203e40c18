"""The decoder stack (port of ``init_params``, ``lm_hidden``,
``_res_scale``, ``_ssm_block``, ``_shared_block_params``, ``encode``,
``_cross_attn`` and ``decoder_hidden`` in ``repro/models/transformer.py``):
GQA decoders, dense or MoE, the vlm backbone among them (pixtral: a dense
GQA decoder whose sequence starts with the patch embeddings), MLA+MoE
decoders (deepseek-v2), the encoder-decoder (``encdec``, whisper: a
non-causal GQA encoder over the frame embeddings, then decoder layers with
causal self-attention, cross-attention to the encoder's output and an MLP),
the attention-free Mamba-2 stack (``ssm``, mamba2) and the ``hybrid`` one
(zamba2: Mamba-2 layers with one of two shared attention + MLP blocks after
every ``hybrid_attn_every``-th).

Parameters are a nested dict of tensors in the reference's layout: per-layer
weights stacked on a leading [L] axis (``wq`` [L, d, H, hd], ``wo``
[L, H, hd, d], ...).  A MoE layer holds ``moe`` (router, ``we_*``,
``ws_*``) where a dense layer holds ``mlp``; as in the reference, every layer
of a MoE config is a MoE layer, and an MLA layer's ``attn`` holds the MLA
projections (``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wo``, ``wdq``/``wuq``).
An encdec model holds ``enc_layers`` (attention + MLP layers), ``enc_norm``
and decoder ``layers`` that add ``cross_norm`` and ``cross`` (GQA
projections).  Init runs on the device from a seeded
``torch.Generator``, so full width needs no weights file.  The numbers
differ from ``jax.random``'s; tests carry the reference's weights across
with :func:`repro_torch.convert.params_from_jax` instead.  An ssm layer
holds ``norm`` and ``mamba`` (the projections, convolutions, ``A_log``,
``D``, ``dt_bias``, the gated norm's weight and ``w_out``); the hybrid's
``shared_attn`` is two attention layers stacked on a leading [2] axis.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from . import attention as attn
from .common import dense_init, rms_norm, swiglu
from .moe import init_moe, moe_ffn_dispatch
from .ssm import init_mamba, mamba_train

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg) -> None:
    """The families the port builds: dense GQA decoders, windowed or not
    (the vlm backbone among them), GQA or MLA decoders with MoE FFNs and
    full (unwindowed) attention, the encdec family with unwindowed GQA, the
    ssm family and the hybrid one with unwindowed GQA shared blocks.
    Anything else raises."""
    unwindowed = all(w == 0 for w in cfg.layer_windows)
    if cfg.attn_kind == "gqa" and cfg.family == "dense":
        return
    if cfg.family == "ssm" or (cfg.family == "hybrid" and cfg.attn_kind == "gqa"
                               and unwindowed and not cfg.is_moe):
        return
    if cfg.family == "moe" and cfg.is_moe and unwindowed:
        return
    if cfg.family in ("encdec", "vlm") and cfg.attn_kind == "gqa" and unwindowed \
            and not cfg.is_moe:
        return
    raise NotImplementedError(f"the port builds dense GQA decoders, unwindowed GQA and "
                              f"MLA MoE decoders, unwindowed GQA encdec and vlm models, "
                              f"ssm and hybrid stacks: "
                              f"{cfg.name} ({cfg.family}, {cfg.attn_kind})")


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random decoder parameters on ``device`` (default ``cuda``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers

    def init(d_in, shape):
        return dense_init(d_in, shape, dtype, generator=gen, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params: Dict[str, Any] = {"embed": init(d, (V, d)), "final_norm": zeros((d,))}
    if not cfg.tie_embeddings:
        params["unembed"] = init(d, (d, V))
    if cfg.is_ssm:
        params["layers"] = {"norm": zeros((L, d)),
                            "mamba": init_mamba(cfg, dtype, generator=gen, device=dev,
                                                n_layers=L)}
        if cfg.family == "hybrid":
            # two alternating shared attention + MLP blocks
            params["shared_attn"] = _gqa_layers(cfg, 2, init, zeros, dev)
        return params
    if cfg.family == "encdec":
        params["enc_layers"] = _gqa_layers(cfg, cfg.n_enc_layers, init, zeros, dev)
        dec = _gqa_layers(cfg, cfg.n_dec_layers, init, zeros, dev)
        dec["cross_norm"] = zeros((cfg.n_dec_layers, d))
        dec["cross"] = _gqa_proj(cfg, cfg.n_dec_layers, init, dev)
        params["layers"] = dec
        params["enc_norm"] = zeros((d,))
        return params
    if cfg.attn_kind == "mla":
        params["layers"] = {
            "attn_norm": zeros((L, d)),
            "attn": attn.init_mla(cfg, dtype, generator=gen, device=dev, n_layers=L),
            "mlp_norm": zeros((L, d)),
            "moe": init_moe(cfg, dtype, generator=gen, device=dev, n_layers=L),
        }
        return params
    if cfg.family == "moe":
        params["layers"] = _gqa_layers(cfg, L, init, zeros, dev, mlp=False)
        params["layers"]["moe"] = init_moe(cfg, dtype, generator=gen, device=dev,
                                           n_layers=L)
    else:
        params["layers"] = _gqa_layers(cfg, L, init, zeros, dev)
    return params


def _gqa_proj(cfg, L: int, init, dev):
    """``L`` GQA projection sets (``wq``, ``wk``, ``wv``, ``wo``) stacked on
    a leading axis, the padded head slices zero."""
    d, hd = cfg.d_model, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Hp, Hkvp = cfg.eff_heads
    gqa = {
        "wq": init(d, (L, d, Hp, hd)),
        "wk": init(d, (L, d, Hkvp, hd)),
        "wv": init(d, (L, d, Hkvp, hd)),
        "wo": init(H * hd, (L, Hp, hd, d)),
    }
    if Hp != H or Hkvp != Hkv:
        # zero the padded head slices, exactly as the reference does
        G, Gp = H // Hkv, Hp // Hkvp
        idx = torch.arange(Hp, device=dev)
        dtype = gqa["wq"].dtype
        q_real = ((idx % Gp < G) & (idx // Gp < Hkv)).to(dtype)
        kv_real = (torch.arange(Hkvp, device=dev) < Hkv).to(dtype)
        gqa["wq"] *= q_real[None, None, :, None]
        gqa["wo"] *= q_real[None, :, None, None]
        gqa["wk"] *= kv_real[None, None, :, None]
        gqa["wv"] *= kv_real[None, None, :, None]
    return gqa


def _gqa_layers(cfg, L: int, init, zeros, dev, mlp: bool = True):
    """``L`` GQA attention layers stacked on a leading axis (norms,
    projections and, with ``mlp``, the SwiGLU MLP)."""
    d, f = cfg.d_model, cfg.d_ff
    layers = {"attn_norm": zeros((L, d)), "attn": _gqa_proj(cfg, L, init, dev),
              "mlp_norm": zeros((L, d))}
    if mlp:
        layers["mlp"] = {"wg": init(d, (L, d, f)), "wu": init(d, (L, d, f)),
                         "wd": init(f, (L, f, d))}
    return layers


def layer_params(params, idx: int, key: str = "layers"):
    """Views of layer ``idx`` of the stacked per-layer parameters under ``key``."""

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[idx] for k, v in tree.items()}

    return take(params[key])


def shared_block_params(params, layer_idx: int, every: int):
    """The hybrid's shared attention block that follows ssm layer
    ``layer_idx``: set ``(layer_idx // every) % 2`` of ``shared_attn``."""
    return layer_params(params, (layer_idx // every) % 2, "shared_attn")


def shared_attn_after(cfg, idx: int) -> bool:
    """True where the hybrid applies a shared attention block after ssm layer ``idx``."""
    every = cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    return bool(every) and (idx + 1) % every == 0


def _res_scale(cfg) -> float:
    return 1.4 / math.sqrt(cfg.n_layers) if cfg.depth_scaled_residual else 1.0


def _attn_block(h, p, cfg, positions, window: int, chunk: int, causal: bool = True):
    """One layer (pre-norm attention then FFN) on the residual stream:
    returns (h, the layer's MoE aux loss, 0 for a dense layer).  With
    ``causal=False`` (the encoder) the self-attention sees every position."""
    s = _res_scale(cfg)
    hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    if causal:
        fwd = attn.mla_train if cfg.attn_kind == "mla" else attn.gqa_train
        a = fwd(hn, p["attn"], cfg, positions, window=window, chunk=chunk)
    else:
        a = attn.gqa_train(hn, p["attn"], cfg, positions, window=0, chunk=chunk,
                           causal=False)
    h = h + s * a
    hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_ffn_dispatch(hn, p["moe"], cfg)
    else:
        m, aux = swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"]), 0.0
    return h + s * m, aux


def _ssm_block(h, p, cfg):
    """One pre-norm Mamba-2 layer on the residual stream."""
    return h + mamba_train(rms_norm(h, p["norm"], cfg.norm_eps), p["mamba"], cfg)


def lm_hidden(params, cfg, x, positions, *, remat: bool = True, chunk: int = 1024):
    """Run the decoder stack on embeddings ``x`` [B, S, d] -> (hidden, the
    summed MoE aux loss).  ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant, as ``jax.checkpoint`` does in
    the reference's layer scan), so a ws MoE layer launches its expert
    kernel twice a step (forward and replay) and its grad kernel once.  The
    ssm and hybrid stacks run their Mamba-2 layers, the hybrid a shared
    attention block after every ``hybrid_attn_every``-th.  The vlm backbone
    runs here on the patches and the text together, as a dense decoder."""
    check_supported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    if cfg.is_ssm:
        for idx in range(cfg.n_layers):
            blocks = [lambda h, p=layer_params(params, idx): _ssm_block(h, p, cfg)]
            if shared_attn_after(cfg, idx):
                sp = shared_block_params(params, idx, cfg.hybrid_attn_every)
                blocks.append(lambda h, sp=sp: _attn_block(h, sp, cfg, positions, 0, chunk)[0])
            for block in blocks:
                h = checkpoint(block, h, use_reentrant=False) if remat else block(h)
        return h, aux
    for idx, w in enumerate(cfg.layer_windows):
        p = layer_params(params, idx)

        def block(h, p=p, w=w):
            return _attn_block(h, p, cfg, positions, w, chunk)

        h, a = checkpoint(block, h, use_reentrant=False) if remat else block(h)
        aux = aux + a
    return h, aux


def _layers(fn, h, n: int, remat: bool):
    """``h = fn(h, idx)`` for each layer ``idx < n``, each recomputed in the
    backward with ``remat``."""
    for idx in range(n):
        h = checkpoint(fn, h, idx, use_reentrant=False) if remat else fn(h, idx)
    return h


def encode(params, cfg, frames, *, remat: bool = True, chunk: int = 1024):
    """The encdec encoder: ``frames`` [B, enc_S, d] (the stub frontend's
    precomputed frame embeddings) through the non-causal attention + MLP
    layers, then ``enc_norm``.  The frames are taken in the model's dtype
    (the reference lets the first product promote a bf16 model to the
    frames' fp32; an fp32 model reads the same numbers either way)."""
    B, S, _ = frames.shape
    positions = torch.arange(S, device=frames.device).expand(B, S)

    def layer(h, idx):
        p = layer_params(params, idx, "enc_layers")
        return _attn_block(h, p, cfg, positions, 0, chunk, causal=False)[0]

    h = _layers(layer, frames.to(torch_dtype(cfg.dtype)), cfg.n_enc_layers, remat)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def cross_kv(p, enc_out):
    """The cross-attention's k and v [B, enc_S, Hkv, hd] of the encoder's
    output (no rope: the encoder's positions are not the decoder's)."""
    return (torch.einsum("bsd,dhe->bshe", enc_out, p["wk"]),
            torch.einsum("bsd,dhe->bshe", enc_out, p["wv"]))


def _cross_attn(x, p, cfg, enc_kv, chunk: int = 1024):
    """Cross-attention: queries from ``x`` [B, S, d], k and v precomputed
    from the encoder's output; every encoder position visible."""
    k, v = enc_kv
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    rep = p["wq"].shape[1] // p["wk"].shape[1]
    o = attn.flash_ref(q, attn.expand_kv(k, rep), attn.expand_kv(v, rep), causal=False,
                       window=0, chunk=chunk)
    return torch.einsum("bshe,hed->bsd", o, p["wo"])


def decoder_layer(h, p, cfg, positions, enc_kv, chunk: int):
    """One encdec decoder layer: causal self-attention, cross-attention to
    the encoder's ``enc_kv``, the MLP (no residual scale, as the reference)."""
    hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    h = h + attn.gqa_train(hn, p["attn"], cfg, positions, window=0, chunk=chunk)
    hn = rms_norm(h, p["cross_norm"], cfg.norm_eps)
    h = h + _cross_attn(hn, p["cross"], cfg, enc_kv, chunk)
    hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    return h + swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])


def decoder_hidden(params, cfg, x, positions, enc_out, *, remat: bool = True,
                   chunk: int = 1024):
    """The encdec decoder on token embeddings ``x`` [B, S, d] against the
    encoder's output ``enc_out`` [B, enc_S, d]."""

    def layer(h, idx):
        p = layer_params(params, idx)
        return decoder_layer(h, p, cfg, positions, cross_kv(p["cross"], enc_out), chunk)

    return _layers(layer, x, cfg.n_dec_layers, remat)
