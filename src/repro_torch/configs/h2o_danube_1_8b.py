"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention (same
numbers as ``repro/configs/h2o_danube_1_8b.py``) [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000; SWA window 4096 on
all layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, window=4096, dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, window=8,
)
