"""mamba2-2.7b — attention-free SSD state-space model [arXiv:2405.21060;
unverified].  64L d_model=2560 vocab=50280 ssm_state=128; expand 2 ->
d_inner 5120, headdim 64 -> 80 SSD heads, chunk 128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=8, ssm_chunk=8,
)
