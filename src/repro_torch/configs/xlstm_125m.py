"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 (the xLSTM blocks carry their own projections)
vocab=50304. Alternating mlstm/slstm per the paper's mixed stacks.
Recurrent state is O(1) in sequence length -> long_500k runs.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304,
    layer_pattern=("mlstm", "slstm"),
    sub_quadratic=True,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, vocab=512)
