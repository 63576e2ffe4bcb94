"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUBBED
[arXiv:2212.04356; unverified].

32L d_model=1280 20H (kv=20, full MHA) d_ff=5120 vocab=51866. The assignment
specifies the transformer backbone only: input_specs() provides precomputed
mel-frame embeddings (B, 1500, d_model); the decoder (32L) cross-attends to
the 32L encoder. Decode shapes exercise the decoder KV cache; full attention
-> no long_500k cell.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, head_dim=64,
    encoder_layers=32, encoder_seq=1500, frontend="audio_stub",
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, encoder_layers=2, encoder_seq=32)
