"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 every other layer [arXiv:2403.19887; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Superblock of 8:
attention at position 3, Mamba elsewhere; MoE on odd layers (period 8 % 2 == 0
so the pattern tiles exactly). sub_quadratic: Mamba carries long context.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128,
    layer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    window_pattern=(0,),
    moe_experts=16, moe_topk=2, moe_every=2, moe_offset=1,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    sub_quadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, moe_experts=4, moe_topk=2)
