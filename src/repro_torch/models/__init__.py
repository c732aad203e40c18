"""GQA decoder of the port, dense or MoE (``repro.models`` counterpart)."""

from .attention import KVCache, gqa_decode, gqa_decode_ws, gqa_train
from .config import ModelConfig
from .model import (
    Caches,
    decode_hidden,
    decode_hidden_ws,
    decode_step,
    decode_step_ws,
    init_caches,
    prefill,
    ws_decode_supported,
)
from .moe import init_moe, moe_ffn, moe_ffn_dispatch, router_topk
from .transformer import init_params

__all__ = [
    "Caches", "KVCache", "ModelConfig", "decode_hidden", "decode_hidden_ws", "decode_step",
    "decode_step_ws", "gqa_decode", "gqa_decode_ws", "gqa_train", "init_caches", "init_moe",
    "init_params", "moe_ffn", "moe_ffn_dispatch", "prefill", "router_topk",
    "ws_decode_supported",
]
