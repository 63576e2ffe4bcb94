"""dbrx-132b [moe] — 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4 in
every layer. Full attention -> no long_500k cell.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128,
    moe_experts=16, moe_topk=4, moe_every=1,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512, moe_experts=4, moe_topk=2)
