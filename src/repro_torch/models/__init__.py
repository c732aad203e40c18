"""Decoders of the port (``repro.models`` counterpart): GQA decoders, dense
or MoE, served and trained (dense fp32 ones also through the one-launch
unified step); MLA+MoE decoders (deepseek-v2) served on the dense decode
step and trained; the vlm backbone (pixtral) and the encoder-decoder
(whisper) with their prefill, decode and loss; the Mamba-2 (ssm) and hybrid
stacks served on the dense decode step and trained."""

from .attention import (
    KVCache,
    MLACache,
    flash_ref,
    gqa_decode,
    gqa_decode_ws,
    gqa_train,
    mla_decode,
    mla_train,
)
from .config import ModelConfig, ShapeConfig
from .model import (
    Caches,
    decode_hidden,
    decode_hidden_ws,
    decode_step,
    decode_step_ws,
    init_caches,
    loss_fn,
    prefill,
    vocab_parallel_xent,
    ws_decode_supported,
)
from .moe import init_moe, moe_ffn, moe_ffn_dispatch, router_topk
from .ssm import SSMCache, init_ssm_cache, mamba_decode, mamba_train
from .transformer import init_params, lm_hidden
from .unified import (
    UnifiedStepReport,
    decode_step_unified,
    plain_decode_step_unified,
    unified_step_supported,
)

__all__ = [
    "Caches", "KVCache", "MLACache", "ModelConfig", "SSMCache", "ShapeConfig", "UnifiedStepReport",
    "decode_hidden",
    "decode_hidden_ws", "decode_step", "decode_step_unified", "decode_step_ws", "flash_ref",
    "gqa_decode", "gqa_decode_ws", "gqa_train", "init_caches", "init_moe", "init_params",
    "init_ssm_cache", "lm_hidden", "loss_fn", "mamba_decode", "mamba_train", "mla_decode",
    "mla_train", "moe_ffn", "moe_ffn_dispatch",
    "plain_decode_step_unified", "prefill", "router_topk", "unified_step_supported",
    "vocab_parallel_xent", "ws_decode_supported",
]
