"""llama3.2-3b — dense GQA decoder (same numbers as ``repro/configs/llama3_2_3b.py``).

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256; RoPE theta 500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, rope_theta=10000.0,
)
