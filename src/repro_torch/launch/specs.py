"""Shape-and-dtype stand-ins for every (arch x shape) dry-run cell — the
JAX package's ``launch/specs.py``.

Where the JAX package builds ``jax.ShapeDtypeStruct`` trees, the port
builds :class:`TensorSpec` trees: a shape and a torch dtype, which
:meth:`TensorSpec.meta` turns into a tensor on the ``meta`` device (what the
dry run, :mod:`.dryrun`, traces the steps on). ``batch_specs`` gives the
inputs of the step a cell runs: train and prefill take (B, seq) token
batches, decode one new token against a cache of seq_len; whisper gets
stub frame embeddings and internvl2 stub patch embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models import cache_schema, model_schema
from ..models.config import ModelConfig, ShapeConfig
from ..models.schema import Sharding, placements_for, tree_map
from ..sharding import rules


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype (the JAX package's ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self) -> torch.Tensor:
        """An uninitialised tensor of this spec on the ``meta`` device."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


def abstract(schema):
    """A :class:`TensorSpec` per leaf of a ``ParamSpec`` tree (the JAX
    package's ``schema.abstract``)."""
    return tree_map(lambda s: TensorSpec(tuple(s.shape), s.dtype), schema)


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The assignment's skip rules (documented in DESIGN.md)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode skipped"
    return True, ""


def _embeds(cfg: ModelConfig, b: int, n: int) -> TensorSpec:
    return TensorSpec((b, n, cfg.d_model), torch.bfloat16)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, TensorSpec]:
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        tokens = TensorSpec((b, shape.seq_len), torch.int32)
        out = {"tokens": tokens}
        if shape.kind == "train":
            out["labels"] = tokens
        if cfg.frontend == "audio_stub":
            out["frames"] = _embeds(cfg, b, cfg.encoder_seq)
        elif cfg.frontend == "vision_stub":
            out["pixel_embeds"] = _embeds(cfg, b, cfg.prefix_len)
        return out
    # decode: one new token with a KV cache of seq_len
    out = {"tokens": TensorSpec((b, 1), torch.int32)}
    if cfg.frontend == "audio_stub":
        out["encoder_out"] = _embeds(cfg, b, cfg.encoder_seq)
    return out


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """A :class:`~repro_torch.models.schema.Sharding` per batch input: dim
    0 by the batch spec, the rest replicated."""
    bspec = rules.batch_pspec(mesh, shape.global_batch)
    out = {}
    for k, v in batch_specs(cfg, shape).items():
        parts = (bspec[0] if bspec else None,) + (None,) * (len(v.shape) - 1)
        out[k] = Sharding(mesh, parts, placements_for(parts, mesh))
    return out


def cache_max_seq(cfg: ModelConfig, shape: ShapeConfig) -> int:
    extra = cfg.prefix_len if cfg.frontend == "vision_stub" else 0
    return shape.seq_len + extra


def decode_cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    sch = cache_schema(cfg, shape.global_batch, cache_max_seq(cfg, shape))
    return abstract(sch), sch


def param_specs(cfg: ModelConfig):
    sch = model_schema(cfg)
    return abstract(sch), sch
