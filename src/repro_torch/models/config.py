"""Model configuration, a copy of the JAX package's ``models/config.py``:
the same fields and shape cells, so one config means the same model in
both packages."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    # layer pattern, cycled over layers: attn | mamba | slstm | mlstm
    layer_pattern: Tuple[str, ...] = ("attn",)
    # sliding-window size per pattern position (0 = global attention)
    window_pattern: Tuple[int, ...] = (0,)
    qkv_bias: bool = False
    # MoE: layers where (layer_idx % moe_every == moe_offset) use MoE MLP
    moe_experts: int = 0
    moe_topk: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    # mamba (jamba-style)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # encoder-decoder (whisper) / multimodal stub frontends
    encoder_layers: int = 0
    encoder_seq: int = 0                      # stub frames/patches length
    frontend: str = "none"                    # none | audio_stub | vision_stub
    prefix_len: int = 0                       # vision prefix tokens (vlm)
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # sub-quadratic capable? (drives long_500k applicability)
    sub_quadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % self.pattern_period]

    def layer_window(self, i: int) -> int:
        return self.window_pattern[i % len(self.window_pattern)]

    def layer_is_moe(self, i: int) -> bool:
        return (self.moe_experts > 0
                and i % self.moe_every == self.moe_offset)

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0 or self.n_kv_heads == 0
        if self.moe_experts:
            assert 0 < self.moe_topk <= self.moe_experts
        assert self.n_layers % self.pattern_period == 0, \
            (self.name, self.n_layers, self.pattern_period)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
