"""internvl2-1b [vlm] — InternViT frontend (STUB patch embeddings) + an
InternLM2-0.9B decoder backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The vision tower is a
stub per the assignment: input_specs() provides precomputed pixel embeddings
(B, 256, d_model) prepended to the text sequence. Full attention -> no
long_500k cell.
"""

import dataclasses
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655,
    frontend="vision_stub", prefix_len=256,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=56, n_heads=7, n_kv_heads=1, d_ff=112,
    vocab=500, prefix_len=16)
