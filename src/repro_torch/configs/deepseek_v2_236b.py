"""deepseek-v2-236b — MLA + MoE (same numbers as ``repro/configs/deepseek_v2_236b.py``).

60L d_model=5120 128H (head dim 128) d_ff(expert)=1536 vocab=102400; MLA
kv_lora=512 q_lora=1536 rope_head_dim=64 v_head_dim=128; MoE 2 shared +
160 routed top-6; every layer MoE (first_k_dense=0, as the reference).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400, attn_kind="mla",
    kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256, attn_kind="mla",
    kv_lora_rank=16, q_lora_rank=16, rope_head_dim=8, v_head_dim=16,
    n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32, capacity_factor=8.0,
)
