"""zamba2-2.7b — hybrid: mamba2 backbone + two alternating SHARED attention
blocks applied every 6 layers [arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 (shared-block MLP)
ssm_state=64.  Shared-block weights are counted once (2 sets).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    hybrid_attn_every=6, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=8, ssm_chunk=8,
    hybrid_attn_every=2,
)
