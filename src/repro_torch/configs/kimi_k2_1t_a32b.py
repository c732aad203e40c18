"""kimi-k2-1t-a32b — large GQA MoE (same numbers as ``repro/configs/kimi_k2_1t_a32b.py``).

61L d_model=7168 64H (GQA kv=8, head dim 112) d_ff(expert)=2048
vocab=163840; MoE 384 routed top-8 + 1 shared expert; every layer MoE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab_size=256,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=32, capacity_factor=8.0,
)
