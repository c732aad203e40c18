"""whisper-base — encoder-decoder audio backbone (same numbers as
``repro/configs/whisper_base.py``).

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865.  The conv
frontend is a stub, as in the reference: a batch carries precomputed frame
embeddings [B, 1500, 512] for the encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, n_dec_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865, frontend="frames", enc_seq_len=1500,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, frontend="frames", enc_seq_len=16,
)
