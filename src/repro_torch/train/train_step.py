"""The serve step — the JAX package's ``train/train_step.make_serve_step``.

The train step (``make_train_step``, the optimizer, microbatching) comes
with the training slice.
"""

from __future__ import annotations

import torch

from ..models import forward, logits_from_hidden
from ..models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, use_flash: bool = False):
    """Returns serve_step(params, cache, batch, index, placements=None) ->
    (logits (B, 1, V), cache): the next-token logits at the last position.
    T = prompt for prefill, 1 for decode; with ``cache=None`` a cache-free
    step over the whole prompt, where ``use_flash`` sends attention to the
    flash kernel. ``placements`` (n_layers, E) places an MoE model's
    experts (``models.skewshield.placements_array``). The cache is updated
    in place and returned."""

    @torch.inference_mode()
    def serve_step(params, cache, batch, index, placements=None):
        hidden, new_cache = forward(params, cfg, batch, cache=cache,
                                    cache_index=index, placements=placements,
                                    use_flash=use_flash)
        logits = logits_from_hidden(params, cfg, hidden[:, -1:, :])
        return logits, new_cache

    return serve_step
