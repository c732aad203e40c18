"""The decoder stack (port of ``init_params``, ``lm_hidden`` and
``_res_scale`` in ``repro/models/transformer.py``): GQA decoders, dense or
MoE, and MLA+MoE decoders (deepseek-v2) for training.

Parameters are a nested dict of tensors in the reference's layout: per-layer
weights stacked on a leading [L] axis (``wq`` [L, d, H, hd], ``wo``
[L, H, hd, d], ...).  A MoE layer holds ``moe`` (router, ``we_*``,
``ws_*``) where a dense layer holds ``mlp``; as in the reference, every layer
of a MoE config is a MoE layer, and an MLA layer's ``attn`` holds the MLA
projections (``wdkv``, ``wkr``, ``wuk``, ``wuv``, ``wo``, ``wdq``/``wuq``).  Init runs on the device from a seeded
``torch.Generator``, so full width needs no weights file.  The numbers
differ from ``jax.random``'s; tests carry the reference's weights across
with :func:`repro_torch.convert.params_from_jax` instead.
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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg, training: bool = False) -> None:
    """The families the port builds: dense GQA decoders, GQA decoders with
    MoE FFNs and full (unwindowed) attention, and, for training only
    (``training=True``: init and the training forward), unwindowed MLA
    decoders with MoE FFNs.  Anything else raises."""
    unwindowed = all(w == 0 for w in cfg.layer_windows)
    if cfg.attn_kind == "gqa" and cfg.family == "dense":
        return
    if cfg.attn_kind == "gqa" and cfg.family == "moe" and cfg.is_moe and unwindowed:
        return
    if (training and cfg.attn_kind == "mla" and cfg.family == "moe" and cfg.is_moe
            and unwindowed):
        return
    raise NotImplementedError(f"the port builds dense GQA decoders, unwindowed GQA MoE "
                              f"decoders and (training only) unwindowed MLA MoE decoders: "
                              f"{cfg.name} ({cfg.family}, {cfg.attn_kind})")


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random decoder parameters on ``device`` (default ``cuda``)."""
    check_supported(cfg, training=True)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, V, L, f, hd = cfg.d_model, cfg.padded_vocab, cfg.n_layers, cfg.d_ff, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    Hp, Hkvp = cfg.eff_heads

    def init(d_in, shape):
        return dense_init(d_in, shape, dtype, generator=gen, device=dev)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    params: Dict[str, Any] = {"embed": init(d, (V, d)), "final_norm": zeros((d,))}
    if not cfg.tie_embeddings:
        params["unembed"] = init(d, (d, V))
    if cfg.attn_kind == "mla":
        params["layers"] = {
            "attn_norm": zeros((L, d)),
            "attn": attn.init_mla(cfg, dtype, generator=gen, device=dev, n_layers=L),
            "mlp_norm": zeros((L, d)),
            "moe": init_moe(cfg, dtype, generator=gen, device=dev, n_layers=L),
        }
        return params
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
        q_real = ((idx % Gp < G) & (idx // Gp < Hkv)).to(dtype)
        kv_real = (torch.arange(Hkvp, device=dev) < Hkv).to(dtype)
        gqa["wq"] *= q_real[None, None, :, None]
        gqa["wo"] *= q_real[None, :, None, None]
        gqa["wk"] *= kv_real[None, None, :, None]
        gqa["wv"] *= kv_real[None, None, :, None]
    params["layers"] = {"attn_norm": zeros((L, d)), "attn": gqa, "mlp_norm": zeros((L, d))}
    if cfg.family == "moe":
        params["layers"]["moe"] = init_moe(cfg, dtype, generator=gen, device=dev,
                                           n_layers=L)
    else:
        params["layers"]["mlp"] = {"wg": init(d, (L, d, f)), "wu": init(d, (L, d, f)),
                                   "wd": init(f, (L, f, d))}
    return params


def layer_params(params, idx: int):
    """Views of layer ``idx`` of the stacked per-layer parameters."""

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[idx] for k, v in tree.items()}

    return take(params["layers"])


def _res_scale(cfg) -> float:
    return 1.4 / math.sqrt(cfg.n_layers) if cfg.depth_scaled_residual else 1.0


def _attn_block(h, p, cfg, positions, window: int, chunk: int):
    """One decoder layer (pre-norm attention then FFN) on the residual
    stream: returns (h, the layer's MoE aux loss, 0 for a dense layer)."""
    s = _res_scale(cfg)
    hn = rms_norm(h, p["attn_norm"], cfg.norm_eps)
    fwd = attn.mla_train if cfg.attn_kind == "mla" else attn.gqa_train
    h = h + s * fwd(hn, p["attn"], cfg, positions, window=window, chunk=chunk)
    hn = rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_ffn_dispatch(hn, p["moe"], cfg)
    else:
        m, aux = swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"]), 0.0
    return h + s * m, aux


def lm_hidden(params, cfg, x, positions, *, remat: bool = True, chunk: int = 1024):
    """Run the decoder stack on embeddings ``x`` [B, S, d] -> (hidden, the
    summed MoE aux loss).  ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant, as ``jax.checkpoint`` does in
    the reference's layer scan), so a ws MoE layer launches its expert
    kernel twice a step (forward and replay) and its grad kernel once."""
    check_supported(cfg, training=True)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    for idx, w in enumerate(cfg.layer_windows):
        p = layer_params(params, idx)

        def block(h, p=p, w=w):
            return _attn_block(h, p, cfg, positions, w, chunk)

        h, a = checkpoint(block, h, use_reentrant=False) if remat else block(h)
        aux = aux + a
    return h, aux
