"""gemma3-12b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144. Superblock of 6:
five sliding-window (1024) layers then one global layer. The sliding-window
majority makes long-context decode sub-quadratic in 5/6 of layers; global
layers are linear-per-token at decode -> long_500k runs.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360,
    vocab=262144, head_dim=240,
    layer_pattern=("attn",) * 6,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    sub_quadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, window_pattern=(32, 32, 32, 32, 32, 0))
