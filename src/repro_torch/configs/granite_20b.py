"""granite-20b [dense] — llama-arch code model, MQA [arXiv:2405.04324; hf].

52L d_model=6144 48H (GQA kv=1 = multi-query) d_ff=24576 vocab=49152.
Full attention -> no long_500k cell.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512)
