"""pixtral-12b — vlm: a mistral-nemo backbone behind a vision frontend
(same numbers as ``repro/configs/pixtral_12b.py``).

40L d_model=5120 32H (GQA kv=8, head dim 160) d_ff=14336 vocab=131072.  The
ViT frontend is a stub, as in the reference: a batch carries precomputed
patch embeddings [B, n_patches, d_model] that go before the text, and the
loss covers the text positions only.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, frontend="patch", n_patches=256,
    rope_theta=1_000_000.0, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, frontend="patch", n_patches=4,
)
