"""Model substrate of the port: the JAX package's ``repro.models`` — LMs of
attention, mamba, sLSTM and mLSTM layers with dense or MoE MLPs, the
whisper encoder with cross-attention, the vision prefix, SkewShield expert
placement and the training loss."""

from . import schema
from .config import SHAPES, ModelConfig, ShapeConfig
from .transformer import (cache_schema, decoder_apply, forward, init_cache,
                          lm_loss, logits_from_hidden, model_schema)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "schema", "cache_schema",
    "decoder_apply", "forward", "init_cache", "lm_loss",
    "logits_from_hidden", "model_schema",
]
