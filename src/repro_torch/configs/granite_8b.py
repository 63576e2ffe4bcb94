"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
Full attention -> no long_500k cell.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512)
