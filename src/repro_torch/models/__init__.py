"""Model substrate of the port: attention LMs with dense or MoE MLPs and
SkewShield expert placement and the training loss (the JAX package's
``repro.models``, for the layer kinds ported so far)."""

from . import schema
from .config import SHAPES, ModelConfig, ShapeConfig
from .transformer import (cache_schema, decoder_apply, forward, init_cache,
                          lm_loss, logits_from_hidden, model_schema)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "schema", "cache_schema",
    "decoder_apply", "forward", "init_cache", "lm_loss",
    "logits_from_hidden", "model_schema",
]
