"""Dense GQA decoder of the port (``repro.models`` counterpart)."""

from .attention import KVCache, gqa_decode, gqa_decode_ws, gqa_train
from .config import ModelConfig
from .model import (
    Caches,
    decode_step,
    decode_step_ws,
    init_caches,
    prefill,
    ws_decode_supported,
)
from .transformer import init_params

__all__ = [
    "Caches", "KVCache", "ModelConfig", "decode_step", "decode_step_ws",
    "gqa_decode", "gqa_decode_ws", "gqa_train", "init_caches", "init_params",
    "prefill", "ws_decode_supported",
]
