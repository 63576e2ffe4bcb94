"""qwen2-7b [dense] — GQA with QKV bias [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064. 28 heads do not
divide the 16-way model axis: attention projections fall back to replication
(recorded by the sharding layer), FFN/vocab shard normally.
Full attention -> no long_500k cell.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128, qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=112, vocab=512)
