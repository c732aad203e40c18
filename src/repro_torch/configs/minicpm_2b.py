"""minicpm-2b — dense MHA, tied embeddings, depth-scaled residuals (same
numbers as ``repro/configs/minicpm_2b.py``) [arXiv:2404.06395; hf].

40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760 vocab=122753.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753, tie_embeddings=True,
    depth_scaled_residual=True, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=250, tie_embeddings=True, depth_scaled_residual=True,
)
