"""gemma3-12b — dense GQA with 5:1 local:global attention (same numbers as
``repro/configs/gemma3_12b.py``) [hf:google/gemma-3-1b-pt; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144; head_dim 256,
local window 1024, RoPE theta 1M (global layers).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144, window=1024, locals_per_global=5,
    rope_theta=1_000_000.0, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=8, locals_per_global=5,
)
