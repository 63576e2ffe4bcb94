"""granite-moe-3b-a800m [moe] — 40 experts top-8, finest granularity
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40e top-8 in every layer. The balancer's best showcase: many small
experts -> fine-grained key domain.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    moe_experts=40, moe_topk=8, moe_every=1,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=512, moe_experts=8, moe_topk=2)
