"""Parameter init of the GQA decoder, dense or MoE (port of ``init_params``
and ``_res_scale`` in ``repro/models/transformer.py``).

Parameters are a nested dict of tensors in the reference's layout: per-layer
weights stacked on a leading [L] axis (``wq`` [L, d, H, hd], ``wo``
[L, H, hd, d], ...).  A MoE layer holds ``moe`` (router, ``we_*``,
``ws_*``) where a dense layer holds ``mlp``; as in the reference, every layer
of a MoE config is a MoE layer.  Init runs on the device from a seeded
``torch.Generator``, so full width needs no weights file.  The numbers
differ from ``jax.random``'s; tests carry the reference's weights across
with :func:`repro_torch.convert.params_from_jax` instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .._device import DeviceLike, resolve_device
from .common import dense_init
from .moe import init_moe

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg) -> None:
    """The families the port builds: dense GQA decoders, and GQA decoders
    with MoE FFNs and full (unwindowed) attention.  Anything else raises."""
    if cfg.attn_kind == "gqa" and cfg.family == "dense":
        return
    if (cfg.attn_kind == "gqa" and cfg.family == "moe" and cfg.is_moe
            and all(w == 0 for w in cfg.layer_windows)):
        return
    raise NotImplementedError(f"the port builds dense GQA decoders and unwindowed GQA "
                              f"MoE decoders only: {cfg.name} ({cfg.family}, "
                              f"{cfg.attn_kind})")


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Random decoder parameters on ``device`` (default ``cuda``)."""
    check_supported(cfg)
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
    attn = {
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
        attn["wq"] *= q_real[None, None, :, None]
        attn["wo"] *= q_real[None, :, None, None]
        attn["wk"] *= kv_real[None, None, :, None]
        attn["wv"] *= kv_real[None, None, :, None]
    params["layers"] = {"attn_norm": zeros((L, d)), "attn": attn, "mlp_norm": zeros((L, d))}
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
